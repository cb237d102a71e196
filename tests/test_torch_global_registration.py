"""The global-registration slice end to end against the JAX package on the
CPU: a 2,000-point version of tests/test_ia.py's scene and a copy moved by a
69 deg yaw and half a metre, each through ``voxel_downsample`` ->
``estimate_normals`` -> ``estimate_fpfh`` -> the prerejective RANSAC core,
then point-to-point ``icp`` of the whole clouds from its result ->
``validate_euclidean``.

Each package takes its own path through its own descriptors; the port's
prerejective core gets the samples the JAX function draws for the key
(ROADMAP C17), so both start ICP from a hypothesis of the same draw. Final
transforms agree within 1e-4 (ICP's 1-NN distances differ in rounding,
ROADMAP C1 and C10, and the prerejective winners may differ where
descriptors flip a bin, ROADMAP C19, but both lie in ICP's basin), and both
recover the true motion to 1e-4: the source is an exact copy of the target,
so ICP of the whole clouds has one fixed point (ICP of the two voxel grids,
which sample the scene differently, stops at one of several a few 1e-4
apart, whichever its start is nearest).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import features as jfeat
from pcl_tpu import filters as jfilt
from pcl_tpu.core import transforms as jtf
from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.registration.icp import icp as jicp
from pcl_tpu.registration.validation import validate_euclidean as jvalidate

from pcl_tpu_torch import features as tfeat
from pcl_tpu_torch import filters as tfilt
from pcl_tpu_torch.core.cloud import make_cloud as tmake
from pcl_tpu_torch.registration import ia as tia
from pcl_tpu_torch.registration.icp import icp as ticp
from pcl_tpu_torch.registration.validation import validate_euclidean as tvalidate

jia = importlib.import_module("pcl_tpu.registration.ia")

XI = np.array([0.5, -0.3, 0.4, 0.0, 0.0, 1.2], np.float32)
LEAF = 0.04
VIEW = [0.0, 0.0, 100.0]
N_HYP, N_EVAL, K_CORR = 512, 256, 5


def _scene(n=2000, seed=42):
    """tests/test_ia.py's asymmetric scene."""
    rng = np.random.default_rng(seed)
    n3 = n // 3
    a = np.stack([rng.uniform(0, 2, n3), rng.uniform(0, 1, n3),
                  0.2 * rng.uniform(0, 2, n3) ** 2], 1)
    b = np.stack([rng.uniform(0, 1, n3), np.zeros(n3), rng.uniform(0, 1, n3)], 1)
    t = rng.uniform(0, 2, n - 2 * n3)
    c = np.stack([t, 0.5 + 0.3 * np.sin(3 * t), 0.5 * t], 1)
    pts = np.concatenate([a, b, c]).astype(np.float32)
    return pts + rng.normal(scale=0.005, size=pts.shape).astype(np.float32)


def _jax_chain(pts):
    c = jfilt.voxel_downsample(jmake(jnp.asarray(pts)), LEAF)
    c = jfeat.estimate_normals(c, k=12, viewpoint=jnp.asarray(VIEW))
    return c, jfeat.estimate_fpfh(c, k=16)


def _torch_chain(pts):
    c = tfilt.voxel_downsample(tmake(pts, device="cpu"), LEAF)
    c = tfeat.estimate_normals(c, k=12, viewpoint=VIEW)
    return c, tfeat.estimate_fpfh(c, k=16)


@pytest.mark.parametrize("seed", [1])
def test_slice_global_registration_matches_jax(seed):
    tgt = _scene()
    T_true = np.asarray(jtf.se3_exp(jnp.asarray(XI)))
    src = ((tgt - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)

    (js, jfs), (jt, jft) = _jax_chain(src), _jax_chain(tgt)
    (ts, tfs), (tt, tft) = _torch_chain(src), _torch_chain(tgt)
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_allclose(ts.xyz.numpy(), np.asarray(js.xyz), atol=1e-6)

    key = jax.random.PRNGKey(seed)
    want = jia.prerejective_ransac(js, jfs, jt, jft, key=key, n_hypotheses=N_HYP,
                                   k_corr=K_CORR, inlier_threshold=0.1, n_eval=N_EVAL)
    probs = js.mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    k_smp, k_pick, k_sub = jax.random.split(key, 3)
    sidx = jax.random.categorical(
        k_smp, jnp.log(probs + 1e-30)[None, :].repeat(N_HYP * 3, 0)).reshape(N_HYP, 3)
    pick = jax.random.randint(k_pick, (N_HYP, 3), 0, K_CORR)
    sub = jax.random.categorical(k_sub, jnp.log(probs + 1e-30)[None, :].repeat(N_EVAL, 0))
    cand = tia.feature_knn(tfs, ts.mask, tft, tt.mask, K_CORR)
    got = tia.prerejective_core(ts, tt, cand, *(torch.from_numpy(np.array(a, np.int32))
                                                for a in (sidx, pick, sub)),
                                inlier_threshold=0.1)
    assert bool(got.valid) and bool(want.valid)

    kw = dict(max_corr_dist=0.2, max_iterations=30)
    jsrc, jtgt = jmake(jnp.asarray(src)), jmake(jnp.asarray(tgt))
    tsrc, ttgt = tmake(src, device="cpu"), tmake(tgt, device="cpu")
    jref = jicp(jsrc, jtgt, init_transform=want.transform, **kw)
    tref = ticp(tsrc, ttgt, init_transform=got.transform, **kw)
    Tj, Tt = np.asarray(jref.transform), tref.transform.numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    np.testing.assert_allclose(Tt, T_true, atol=1e-4)

    for T in (Tt, np.eye(4, dtype=np.float32)):
        wv = jvalidate(jsrc, jtgt, jnp.asarray(T), max_range=0.1, threshold=1e-6)
        tv = tvalidate(tsrc, ttgt, torch.from_numpy(np.asarray(T, np.float32)), max_range=0.1,
                       threshold=1e-6)
        assert bool(tv.is_valid) == bool(wv.is_valid) == (T is Tt)
        # the exact 1-NN distance against the matmul identity (ROADMAP C1)
        np.testing.assert_allclose(float(tv.score), float(wv.score), rtol=1e-3, atol=1e-7)
