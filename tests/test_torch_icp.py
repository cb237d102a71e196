"""Parity of pcl_tpu_torch's ICP with pcl_tpu.registration.icp on the CPU.

The port follows the 1-NN kernel's distance contract (exact ||q - t||^2),
which on the JAX side only the Pallas kernel gives: the JAX package's CPU
path returns q^2 + t^2 - 2q.t, and that changes when the absolute-MSE test
fires (30 iterations instead of 6 on the pairs below). So the brute-backend
runs are held, in iterations, convergence code and correspondence count, to
JAX's ``icp`` with ``bruteforce.nn1`` swapped for the Pallas kernel run
through the interpreter; against the unmodified CPU run only the transform is
compared. The cell backend never calls nn1 and is compared as it is."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.ops import pallas_nn
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch.core.cloud import make_cloud as tmake
jicp = importlib.import_module("pcl_tpu.registration.icp")
# in both packages the name "icp" of the registration package is the function
ticp = importlib.import_module("pcl_tpu_torch.registration.icp")

# transforms of the same float32 loop agree far below this; the bound only
# has to absorb summation order (measured ~1e-7)
T_TOL = 1e-5


def _interpret_nn1(target, tmask, queries, **_):
    return pallas_nn.nn1_pallas(target, tmask, queries, qt=128, tt=256, interpret=True)


def _jax(fn, *args, patched, **kw):
    """Run a JAX function, with bruteforce.nn1 swapped for the interpreted
    Pallas kernel when ``patched``. ``icp`` is jitted and keeps the nn1 it
    traced, so the compilation caches are cleared on both sides."""
    jax.clear_caches()
    orig = jbf.nn1
    if patched:
        jbf.nn1 = _interpret_nn1
    try:
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kw))
    finally:
        jbf.nn1 = orig
        jax.clear_caches()


def _motion(ang=0.1, t=(0.05, -0.03, 0.02)):
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return R, np.float32(t)


def _uniform_pair(rng, n=1024, capacity=None):
    tgt = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    R, t = _motion()
    src = (tgt @ R.T + t).astype(np.float32)
    return dict(src=src, tgt=tgt, capacity=capacity)


def _surface_pair(rng, n=1024):
    """A height field z = 0.3 sin 2x cos 2y with analytic normals, moved by a
    small rigid motion (normals rotated with it)."""
    xy = rng.uniform(-1, 1, size=(n, 2))
    x, y = xy[:, 0], xy[:, 1]
    tgt = np.stack([x, y, 0.3 * np.sin(2 * x) * np.cos(2 * y)], 1).astype(np.float32)
    nrm = np.stack([-0.6 * np.cos(2 * x) * np.cos(2 * y),
                    0.6 * np.sin(2 * x) * np.sin(2 * y), np.ones(n)], 1)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    R, t = _motion(0.04, (0.03, -0.02, 0.01))
    return dict(src=(tgt @ R.T + t).astype(np.float32), tgt=tgt, tn=nrm,
                sn=(nrm @ R.T).astype(np.float32), capacity=None)


def _clouds(pair):
    cap = pair["capacity"]
    sa = {"normal": pair["sn"]} if "sn" in pair else None
    ta = {"normal": pair["tn"]} if "tn" in pair else None
    js = jmake(jnp.asarray(pair["src"]), attrs=None if sa is None else
               {k: jnp.asarray(v) for k, v in sa.items()}, capacity=cap)
    jt = jmake(jnp.asarray(pair["tgt"]), attrs=None if ta is None else
               {k: jnp.asarray(v) for k, v in ta.items()}, capacity=cap)
    ts = tmake(pair["src"], attrs=sa, capacity=cap, device="cpu")
    tt = tmake(pair["tgt"], attrs=ta, capacity=cap, device="cpu")
    return js, jt, ts, tt


def _same_result(got, want, transform_only=False):
    np.testing.assert_allclose(got.transform.numpy(), want.transform, atol=T_TOL)
    if transform_only:
        return
    assert int(got.iterations) == int(want.iterations)
    assert int(got.convergence_state) == int(want.convergence_state)
    assert bool(got.converged) == bool(want.converged)
    assert int(got.num_correspondences) == int(want.num_correspondences)
    assert bool(got.truncated) == bool(want.truncated)
    # mean squared distances: exact float32 distances, summed in another order
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               rtol=1e-3, atol=1e-12)


BRUTE = [
    ("point_to_point", _uniform_pair, {}),
    ("reciprocal", _uniform_pair, dict(reciprocal=True)),
    ("point_to_plane", _surface_pair, dict(variant="point_to_plane")),
    ("symmetric", _surface_pair, dict(variant="symmetric")),
    ("gated_init", _uniform_pair, dict(max_corr_dist=0.3,
                                       init_transform=np.eye(4, dtype=np.float32))),
]


@pytest.mark.parametrize("name,make,kw", BRUTE, ids=[b[0] for b in BRUTE])
def test_brute_matches_interpreted_kernel(rng, name, make, kw):
    js, jt, ts, tt = _clouds(make(rng))
    kw = dict(kw, max_iterations=30)
    init = kw.pop("init_transform", None)
    want = _jax(jicp.icp, js, jt, None if init is None else jnp.asarray(init),
                patched=True, **kw)
    got = ticp.icp(ts, tt, None if init is None else torch.from_numpy(init), **kw)
    _same_result(got, want)
    assert int(got.convergence_state) == ticp.CONV_ABS_MSE
    # the unmodified CPU run stops later on its cancellation noise, at the
    # same transform
    plain = _jax(jicp.icp, js, jt, None if init is None else jnp.asarray(init),
                 patched=False, **kw)
    _same_result(got, plain, transform_only=True)


CELL = [
    ("hash", dict(corr_backend="cell", max_corr_dist=0.2, table_size=4096, cell_cap=32)),
    ("dense", dict(corr_backend="cell", max_corr_dist=0.2, cell_cap=32,
                   grid_dims=(7, 7, 7))),
    # overflowing buckets stall the run at a wrong fixed point, where the
    # iteration whose MSE first repeats bit for bit depends on rounding:
    # run all 30 iterations instead
    ("truncated", dict(corr_backend="cell", max_corr_dist=0.2, table_size=4096,
                       cell_cap=2, abs_mse_eps=0.0, rel_mse_eps=0.0)),
    ("auto_switch", dict(max_corr_dist=0.2, table_size=4096, cell_cap=32)),
    ("point_to_plane", dict(corr_backend="cell", max_corr_dist=0.2, cell_cap=64,
                            grid_dims=(7, 7, 5), variant="point_to_plane")),
]


@pytest.mark.parametrize("name,kw", CELL, ids=[c[0] for c in CELL])
def test_cell_backend_matches(rng, name, kw):
    if name == "point_to_plane":
        pair = _surface_pair(rng)
    else:
        # auto_switch: 1024 points padded to a 10240 capacity make 1.05e8
        # candidate pairs, past the brute backend's 1e8 limit
        pair = _uniform_pair(rng, capacity=10240 if name == "auto_switch" else None)
    js, jt, ts, tt = _clouds(pair)
    kw = dict(kw, max_iterations=30)
    want = _jax(jicp.icp, js, jt, patched=False, **kw)
    got = ticp.icp(ts, tt, **kw)
    _same_result(got, want)
    assert bool(got.truncated) == (name == "truncated")


@pytest.mark.parametrize("dims", [None, (7, 7, 7)])
def test_prebuilt_index(rng, dims):
    js, jt, ts, tt = _clouds(_uniform_pair(rng))
    jidx = jicp.build_index(jt, 0.2, cell_cap=32, table_size=4096, grid_dims=dims)
    tidx = ticp.build_index(tt, 0.2, cell_cap=32, table_size=4096, grid_dims=dims)
    np.testing.assert_array_equal(tidx.data.numpy(), np.asarray(jidx.data))
    kw = dict(max_corr_dist=0.2, max_iterations=30, rel_mse_eps=0.0, abs_mse_eps=0.0)
    want = _jax(jicp.icp, js, jt, patched=False, index=jidx, **kw)
    got = ticp.icp(ts, tt, index=tidx, **kw)
    _same_result(got, want)
    assert int(got.iterations) == 30 and int(got.convergence_state) == ticp.CONV_ITERATIONS
    with pytest.raises(ValueError, match="reciprocal"):
        ticp.icp(ts, tt, index=tidx, max_corr_dist=0.2, reciprocal=True)


@pytest.mark.parametrize("case", ["min_correspondences", "no_iterations", "transform_eps"])
def test_stopping_rules(rng, case):
    js, jt, ts, tt = _clouds(_uniform_pair(rng, n=256))
    kw = {"min_correspondences": dict(min_correspondences=300, max_iterations=10),
          "no_iterations": dict(max_iterations=0),
          "transform_eps": dict(max_iterations=30, transformation_eps=1e-6,
                                abs_mse_eps=0.0, rel_mse_eps=0.0)}[case]
    want = _jax(jicp.icp, js, jt, patched=True, **kw)
    got = ticp.icp(ts, tt, **kw)
    _same_result(got, want)
    code = {"min_correspondences": ticp.CONV_FAILED_CORRESPONDENCES,
            "no_iterations": ticp.CONV_RUNNING,
            "transform_eps": ticp.CONV_TRANSFORM}[case]
    assert int(got.convergence_state) == code
    if case == "min_correspondences":          # frozen: the transform never moved
        assert int(got.iterations) == 1
        assert torch.equal(got.transform, torch.eye(4))


def test_fitness_score_and_align(rng):
    js, jt, ts, tt = _clouds(_uniform_pair(rng))
    R, t = _motion()
    inv = np.eye(4, dtype=np.float32)
    inv[:3, :3], inv[:3, 3] = R.T, -R.T @ t
    for max_range in (np.inf, 0.05):
        want = _jax(jicp.fitness_score, js, jt, jnp.asarray(inv), max_range, patched=True)
        got = ticp.fitness_score(ts, tt, torch.from_numpy(inv), max_range)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-12)
    aligned_j, res_j = _jax(jicp.align, js, jt, patched=True, max_iterations=30)
    aligned_t, res_t = ticp.align(ts, tt, max_iterations=30)
    _same_result(res_t, res_j)
    np.testing.assert_allclose(aligned_t.xyz.numpy(), np.asarray(aligned_j.xyz), atol=T_TOL)
    # the aligned source lies on the target
    np.testing.assert_allclose(aligned_t.xyz.numpy(), tt.xyz.numpy(), atol=1e-5)


def test_variant_checks(rng):
    _, _, ts, tt = _clouds(_uniform_pair(rng, n=64))
    for variant in ("point_to_plane", "symmetric", "nope"):
        with pytest.raises(ValueError):
            ticp.icp(ts, tt, variant=variant)
    with pytest.raises(ValueError, match="finite"):
        ticp.icp(ts, tt, corr_backend="cell")
