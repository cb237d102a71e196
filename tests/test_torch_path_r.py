"""Path R as a whole against the JAX package on the CPU: the last 25 CLIs in
the order ``chip_smoke.py`` phase 20 chains them (``chip_smoke.path_r_chain``)
on a quarter of path C's scan (30,000 points, turned z-up) and path L's 80 x 60
frame. The port's tools run first (``--device cpu``); then the JAX package's
tools run each step on the port's inputs (``src``), so that every step is
compared on the same files (``chip_smoke.path_r_compare``):

- the filters', converters' and file tools' bytes equal (a PLY file's writer
  comment aside); the statistical filter's kept points equal but at its
  threshold's rounding or a neighbour tie (``sor_margin``, C12);
- voxel centroids and the demeaned scan within 1e-6 of the scan's extent,
  the smoothed frame within 5e-5, the projected ground within 1e-5;
- normals n.n' >= 1 - 1e-5 on 99% of the voxels (C9), PFH, FPFH and SHOT rows
  within 1e-3 of their scale on 90% (C19's bin flips from those normals),
  VFH and ESF within 2% in L1; the codebook's classes equal (its centroids
  move with those flips: printed, ROADMAP C102), 95% of the labels equal;
- the draws of ``plane_projection``, ESF, the classifier's k-means and
  ``add_gaussian_noise`` are the JAX package's, fed to the port's tools
  (C17).

Then ``chip_smoke.path_r_checks`` on the port's files: uniform sampling keeps
input points, one per cell, and the ground keeps the street's ground and none
of its facades.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import contextlib
import importlib
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import io as jio

from pcl_tpu_torch.registration import trajectory

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
cs = importlib.import_module("chip_smoke")
jransac = importlib.import_module("pcl_tpu.sac.ransac")


def jax_draws(name, argv):
    """The draws of the JAX tools (their default keys) from the step's input
    files, for the port's tools."""
    if name == "plane_projection":
        mask = np.asarray(jio.load(argv[0]).mask)
        n = len(mask)
        w = jnp.asarray(mask).astype(jnp.float32)
        k_idx, k_sub = jax.random.split(jax.random.PRNGKey(0))
        idx = jransac._sample_indices(k_idx, 1024, 3, n, w / jnp.maximum(jnp.sum(w), 1.0))
        sub = jax.random.bernoulli(k_sub, 0.1, (n,)) & jnp.asarray(mask)
        return {"draws": (torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(sub)))}
    if name == "extract_feature esf":
        probs = np.asarray(jio.load(argv[0]).mask).astype(np.float32)
        probs = jnp.asarray(probs / max(probs.sum(), 1.0))
        tri = np.stack([np.asarray(jax.random.categorical(
            k, jnp.log(probs + 1e-30)[None, :].repeat(4096, 0)))
            for k in jax.random.split(jax.random.PRNGKey(0), 3)])
        return {"esf_draws": torch.from_numpy(tri)}
    if name == "train_unary_classifier":
        k = int(argv[argv.index("-clusters") + 1])
        init = []
        for p in argv[:argv.index("-o")]:
            n = int(jio.load(p).count)
            init.append(np.array(jax.random.categorical(
                jax.random.PRNGKey(0),
                jnp.log(jnp.ones(n) / n + 1e-30)[None, :].repeat(min(k, n), 0))))
        return {"init_indices": init}
    if name == "add_gaussian_noise":
        sd, seed = float(argv[argv.index("-sd") + 1]), int(argv[argv.index("-seed") + 1])
        shape = jio.load(argv[0]).xyz.shape
        return {"noise": np.array(jax.random.normal(jax.random.PRNGKey(seed), shape) * sd)}
    return {}


def jax_run(name, tool, argv):
    """The JAX package's CLI of the same name on the same arguments."""
    mod = importlib.import_module(f"pcl_tpu.tools.{tool}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(list(argv)) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    street = cs.make_street(n=cs.SCENE_POINTS // 4)
    scans, golden = trajectory.make_virtual_scan_sequence(
        street, 2, np.random.default_rng(0),
        **dict(cs.SEQUENCE_KW, max_points=cs.R_SMALL["points"]))
    d = {k: tmp_path_factory.mktemp(f"path_r_{k}") for k in ("in", "port", "jax")}
    inp = cs.path_r_inputs(scans, golden, cs.R_SMALL, str(d["in"]))
    port = cs.path_r_chain(inp, str(d["port"]), cs.port_runner("cpu", jax_draws))
    ref = cs.path_r_chain(inp, str(d["jax"]), jax_run, src=str(d["port"]))
    return inp, str(d["port"]), str(d["jax"]), port, ref


def test_every_tool_is_in_the_chain(chains):
    tools = {tool for _, tool, _, _, _ in cs.path_r_steps(chains[0], chains[1])}
    assert len(tools) == 26                    # the 25 and tools.voxel_grid
    assert len(chains[3]) == len(chains[4]) == len(cs.path_r_steps(chains[0], chains[1]))


def test_chain_matches_jax(chains):
    inp, pdir, jdir, port, ref = chains
    failed = []
    lines = cs.path_r_compare(inp, pdir, jdir, port, ref,
                              lambda ok, what: ok or failed.append(what), "port against JAX:")
    print("\n".join(lines))
    assert not failed, failed


def test_path_r_checks_on_the_ports_files(chains):
    inp, pdir = chains[0], chains[1]
    failed = []
    m = cs.path_r_checks(inp, pdir, lambda ok, what: ok or failed.append(what))
    print(m)
    assert not failed, failed
    assert m["ground_voxels"] > 1000 and m["facade_voxels"] > 100 and m["clusters"] >= 3
