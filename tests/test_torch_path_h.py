"""The slice as a whole against the JAX package on the CPU: path H's chain
(a) FPCS, (f) nonlinear ICP and (h) incremental registration, at a quarter
of a scan (``chip_smoke.py``'s street and path E's cut, 30,000-point scans,
0.3 m voxels; path C's scans at 0.2 m for (h)).

- (a): the port's FPCS core on the JAX package's own draws (ROADMAP C17),
  with fewer bases and a smaller scoring subset than the defaults (the plain
  1-NN on the CPU is slow): the error to 3e-3 (C1: the JAX error is the
  square root of the matmul identity's rounding at distances of tens of
  metres) and the best transform to 1e-4;
- (f): ``icp_nl`` from the motion moved 0.28 m and 0.02 rad, both packages
  from the same start, with B1's exact distances on the JAX side (the Pallas
  kernel interpreted): iterations and code alike, the transform to 1e-3 (along
  the street the LM system is nearly singular, ROADMAP C22, and float32
  rounding moves its steps there: 5.4e-4 measured after eight iterations);
- (h): ``IncrementalRegistration`` with path C's point-to-plane ICP on the
  cell list (both packages' cell lists return the same neighbours; with the
  brute 1-NN their distances differ, C1, and the stopping iteration along the
  street with them) over two scans of 10,000 points: absolute poses to 1e-4,
  as ``tests/test_torch_trajectory.py`` holds ``odometry_sequence``."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.ops import pallas_nn
from pcl_tpu.registration import fpcs as jfpcs
from pcl_tpu.registration import incremental as jinc
from pcl_tpu.registration import variants as jvar
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch.core.cloud import Cloud, make_cloud
from pcl_tpu_torch.registration import fpcs as tfpcs
from pcl_tpu_torch.registration import incremental as tinc
from pcl_tpu_torch.registration import trajectory as ttraj
from pcl_tpu_torch.registration import variants as tvar

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
cs = importlib.import_module("chip_smoke")

QUARTER = 30_000


@pytest.fixture(scope="module")
def pair(monkeypatch_module):
    """Path E's pair at a quarter of a scan: ground removed, 0.3 m voxels,
    normals; numpy arrays of the live voxels and the motion."""
    from pcl_tpu_torch import features, filters, sac, segmentation

    monkeypatch_module.setitem(cs.SEQUENCE_KW, "max_points", QUARTER)
    street = cs.make_street(n=cs.SCENE_POINTS // 4)
    rng = np.random.default_rng(cs.E_SEED)
    P = cs.pose_matrix(*cs.E_POSE)
    out = []
    for pose in (np.eye(4), P):
        c = make_cloud(cs.scan_at(street, pose, rng), device="cpu")
        seg = segmentation.sac_segmentation(c, sac.PlaneModel(), cs.E_GROUND_THRESHOLD)
        v = cs.live_rows(filters.voxel_downsample(c.with_mask(~seg.inliers), cs.E_LEAF))
        out.append(features.estimate_normals(v, k=cs.NORMAL_K))
    return out[1], out[0], P, street


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _j(c: Cloud) -> JCloud:
    return JCloud(xyz=jnp.asarray(c.xyz.numpy()), mask=jnp.asarray(c.mask.numpy()),
                  attrs={k: jnp.asarray(v.numpy()) for k, v in c.attrs.items()})


def _logp(mask):
    p = jnp.asarray(mask).astype(jnp.float32)
    return jnp.log(p / jnp.maximum(jnp.sum(p), 1.0) + 1e-30)[None, :]


def test_a_fpcs(pair):
    src, tgt, _, _ = pair
    js, jt = _j(src), _j(tgt)
    key = jax.random.PRNGKey(0)
    nb, M, P, ne = 16, 512, 8, 64
    want = jfpcs.fpcs_align(js, jt, key=key, n_bases=nb, n_eval=ne)
    kb, _, kt, kp, ke = jax.random.split(key, 5)
    draws = [jax.random.categorical(kt, _logp(jt.mask).repeat(M, 0)),
             jax.random.categorical(kb, _logp(js.mask).repeat(nb * 3, 0)).reshape(nb, 3),
             jax.random.randint(kp, (nb, P, 2), 0, M),
             jax.random.categorical(ke, _logp(js.mask).repeat(ne, 0))]
    got = tfpcs.fpcs_core(src, tgt, *(torch.from_numpy(np.array(d.astype(jnp.int32)))
                                      for d in draws))
    assert bool(got.valid) == bool(want.valid)
    if bool(want.valid):
        assert float(got.error) == pytest.approx(float(want.error), abs=3e-3)
        np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)


def _interpret_nn1(target, tmask, queries, **_):
    return pallas_nn.nn1_pallas(target, tmask, queries, qt=128, tt=256, interpret=True)


def test_f_icp_nl(pair):
    src, tgt, P, _ = pair
    start = P.copy()
    start[:3, 3] += [0.2, 0.0, 0.2]
    a = 0.02
    start[:3, :3] = start[:3, :3] @ np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                                              [-math.sin(a), 0, math.cos(a)]])
    start = start.astype(np.float32)
    kw = dict(warp="rigid_6d", max_corr_dist=1.0, max_iterations=4)
    jax.clear_caches()
    orig = jbf.nn1
    jbf.nn1 = _interpret_nn1
    try:
        want = jax.tree_util.tree_map(np.asarray, jvar.icp_nl(_j(src), _j(tgt),
                                                              jnp.asarray(start), **kw))
    finally:
        jbf.nn1 = orig
        jax.clear_caches()
    got = tvar.icp_nl(src, tgt, torch.from_numpy(start), **kw)
    np.testing.assert_allclose(got.transform.numpy(), want.transform, atol=1e-3)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.convergence_state) == int(want.convergence_state)
    # it moves towards the motion
    assert np.abs(got.transform.numpy()[:3, 3] - P[:3, 3]).max() < 0.2


def test_h_incremental(pair):
    from pcl_tpu_torch import features, filters

    street = pair[3]
    scans, _ = ttraj.make_virtual_scan_sequence(street, 2, np.random.default_rng(0),
                                                **dict(cs.SEQUENCE_KW, max_points=10_000))
    kw = dict(cs.ICP_KW, corr_backend="cell")
    clouds = [features.estimate_normals(cs.live_rows(filters.voxel_downsample(
        make_cloud(s, device="cpu"), cs.LEAF)), k=cs.NORMAL_K) for s in scans]
    jreg, treg = jinc.IncrementalRegistration(**kw), tinc.IncrementalRegistration(**kw)
    for c in clouds:
        assert treg.register_cloud(c) == jreg.register_cloud(_j(c))
        np.testing.assert_allclose(treg.absolute_transform.numpy(),
                                   np.asarray(jreg.absolute_transform), atol=1e-4)
