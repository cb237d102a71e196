"""Parity of pcl_tpu_torch.registration.{variants,incremental} with the JAX
package on the CPU.

The port follows kernel B1's exact distances (ROADMAP C1), which on the
JAX side only the Pallas kernel gives; so ``icp_nl`` and ``joint_icp`` are
held in iterations, convergence code and correspondence count to the JAX
functions with ``bruteforce.nn1`` swapped for the Pallas kernel run through
the interpreter, and in transform (1e-5) and fitness (1e-7 absolute) to
both that run and the unmodified CPU run (1e-4: another stopping
iteration at the same optimum). The incremental and meta accumulators are
held to the JAX ones over three scans: poses 1e-4, the model's size
exactly."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.core.transforms import se3_exp as jse3
from pcl_tpu.ops import pallas_nn
from pcl_tpu.registration import incremental as jinc
from pcl_tpu.registration import variants as jvar
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.registration import incremental as tinc
from pcl_tpu_torch.registration import variants as tvar


def _interpret_nn1(target, tmask, queries, **_):
    return pallas_nn.nn1_pallas(target, tmask, queries, qt=128, tt=256, interpret=True)


def _jax(fn, *args, patched, **kw):
    """The JAX function, with bruteforce.nn1 swapped for the interpreted
    Pallas kernel when ``patched`` (jit caches cleared on both sides)."""
    jax.clear_caches()
    orig = jbf.nn1
    if patched:
        jbf.nn1 = _interpret_nn1
    try:
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kw))
    finally:
        jbf.nn1 = orig
        jax.clear_caches()


def _jc(x):
    return JCloud(xyz=jnp.asarray(x), mask=jnp.ones(len(x), bool))


def _tc(x):
    return make_cloud(x, device="cpu")


def _check(got, want, exact):
    np.testing.assert_allclose(got.transform.numpy(), want.transform, atol=1e-5 if exact else 1e-4)
    if exact:
        assert int(got.iterations) == int(want.iterations)
        assert int(got.convergence_state) == int(want.convergence_state)
        assert int(got.num_correspondences) == int(want.num_correspondences)
        assert float(got.fitness) == pytest.approx(float(want.fitness), abs=1e-7)
    assert bool(got.converged) == bool(want.converged)


@pytest.mark.parametrize("warp,patched", [("rigid_6d", True), ("rigid_6d", False),
                                          ("rigid_3d", True), ("translation", True)],
                         ids=["rigid_6d-pallas", "rigid_6d-cpu", "rigid_3d-pallas",
                              "translation-pallas"])
def test_icp_nl_matches_jax(warp, patched):
    rng = np.random.default_rng(7)
    tgt = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    src = (tgt + np.float32([0.05, -0.02, 0.03])).astype(np.float32)
    kw = dict(max_corr_dist=0.3, max_iterations=20, warp=warp)
    want = _jax(jvar.icp_nl, _jc(src), _jc(tgt), patched=patched, **kw)
    got = tvar.icp_nl(_tc(src), _tc(tgt), **kw)
    _check(got, want, patched)


def test_icp_nl_transformation_eps_and_init():
    rng = np.random.default_rng(8)
    tgt = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    T = np.asarray(jse3(jnp.asarray([0.04, 0.02, -0.03, 0.02, -0.01, 0.03], jnp.float32)))
    src = ((tgt - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.01, 0.0, 0.0]
    kw = dict(max_corr_dist=0.5, max_iterations=30, transformation_eps=1e-9)
    want = _jax(jvar.icp_nl, _jc(src), _jc(tgt), jnp.asarray(init), patched=True, **kw)
    got = tvar.icp_nl(_tc(src), _tc(tgt), torch.from_numpy(init), **kw)
    _check(got, want, True)


def _joint_pairs():
    T = np.asarray(jse3(jnp.asarray([0.02, -0.01, 0.015, 0.02, -0.01, 0.03], jnp.float32)))
    inv = np.linalg.inv(T)
    pairs = []
    for seed, n in ((1, 300), (2, 200)):
        tgt = np.random.default_rng(seed).uniform(-1, 1, size=(n, 3)).astype(np.float32)
        pairs.append(((tgt @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32), tgt))
    return pairs, T


@pytest.mark.parametrize("patched", [True, False], ids=["pallas", "cpu"])
def test_joint_icp_matches_jax(patched):
    pairs, T = _joint_pairs()
    kw = dict(max_corr_dist=0.3, max_iterations=40)
    want = _jax(jvar.joint_icp, [_jc(s) for s, _ in pairs], [_jc(t) for _, t in pairs],
                patched=patched, **kw)
    got = tvar.joint_icp([_tc(s) for s, _ in pairs], [_tc(t) for _, t in pairs], **kw)
    _check(got, want, patched)
    np.testing.assert_allclose(got.transform.numpy(), T, atol=5e-3)


def test_joint_icp_refuses_unequal_lists():
    with pytest.raises(ValueError):
        tvar.joint_icp([_tc(np.zeros((4, 3), np.float32))], [])


def _scans():
    rng = np.random.default_rng(9)
    base = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    scans = [base]
    for k in range(1, 3):
        T = np.asarray(jse3(jnp.asarray([0.03 * k, -0.01 * k, 0.02, 0.0, 0.02 * k, 0.01],
                                        jnp.float32)))
        scans.append(((base - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
    return scans


@pytest.mark.parametrize("kind", ["incremental", "meta"])
def test_accumulators_match_jax(kind):
    kw = dict(max_corr_dist=0.3, max_iterations=30)
    jcls = jinc.IncrementalRegistration if kind == "incremental" else jinc.MetaRegistration
    tcls = tinc.IncrementalRegistration if kind == "incremental" else tinc.MetaRegistration
    jreg, treg = jcls(**kw), tcls(**kw)
    for s in _scans():
        assert treg.register_cloud(_tc(s)) == jreg.register_cloud(_jc(s))
        np.testing.assert_allclose(treg.absolute_transform.numpy(),
                                   np.asarray(jreg.absolute_transform), atol=1e-4)
    if kind == "meta":
        assert treg.model.capacity == jreg.model.capacity
        np.testing.assert_array_equal(treg.model.mask.numpy(), np.asarray(jreg.model.mask))
    else:
        treg.reset()
        assert treg.register_cloud(_tc(_scans()[0]))
        np.testing.assert_array_equal(treg.absolute_transform.numpy(), np.eye(4))


def test_incremental_custom_register_keeps_failed_scan_out():
    calls = []

    class Res:
        def __init__(self, ok):
            self.converged = torch.tensor(ok)
            self.transform = torch.eye(4)

    def register(s, t):
        calls.append((s, t))
        return Res(len(calls) != 1)

    reg = tinc.IncrementalRegistration(register=register)
    a, b, c = (_tc(s) for s in _scans())
    assert reg.register_cloud(a)
    assert not reg.register_cloud(b)         # failed: a stays the last scan
    assert reg.register_cloud(c)
    assert calls[1][1] is a
