"""Parity of the rest of pcl_tpu_torch.registration.estimation with the JAX
package on the CPU: the quaternion helpers, the dual-quaternion, planar and
3-point closed forms, the warps, their Jacobians against ``jax.jacfwd``
(at ``params = 0``, where ``se3_exp`` takes its small-angle branch, and away
from it), and Levenberg-Marquardt over each warp.

Tolerances: closed forms 1e-5 (float32 sums in another order; the
dual-quaternion rotation is an eigenvector of a 4x4, ``eigh`` in each
package); Jacobians 1e-6 (the port's closed forms, and ``torch.func.jacfwd``
for the quaternion warp, against ``jax.jacfwd``: the same derivative in
another order of rounding); LM transforms 1e-5 after ten steps on a
consistent pair, 1e-4 for the planar warp, which cannot reach the 3-D
motion and stops where its damping leaves it."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.transforms import se3_exp as jse3
from pcl_tpu.registration import estimation as je

from pcl_tpu_torch.registration import estimation as te

WARPS = {"warp_rigid_6d": 6, "warp_rigid_6d_quat": 6, "warp_rigid_3d": 3,
         "warp_translation": 3}


def _pair(seed=0, n=200, outliers=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3)).astype(np.float32)
    T = np.asarray(jse3(jnp.asarray([0.1, -0.2, 0.3, 0.2, 0.1, -0.15], jnp.float32)))
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    dst[:outliers] += 3.0
    w = (np.arange(n) >= outliers).astype(np.float32)
    return src, dst, w, T


def _both(name, *arrays, **kw):
    a = np.asarray(getattr(je, name)(*map(jnp.asarray, arrays), **kw))
    b = getattr(te, name)(*(torch.from_numpy(np.asarray(x)) for x in arrays), **kw).numpy()
    return a, b


@pytest.mark.parametrize("name", ["_quat_left", "_quat_right"])
def test_quaternion_matrices(name):
    q = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    a, b = _both(name, q)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("outliers", [0, 40])
def test_dual_quaternion(outliers):
    src, dst, w, T = _pair(outliers=outliers)
    a, b = _both("estimate_dual_quaternion", src, dst, w)
    np.testing.assert_allclose(b, a, atol=1e-5)
    np.testing.assert_allclose(b, T, atol=1e-5)


def test_estimate_2d():
    rng = np.random.default_rng(2)
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                 np.float32)
    src = rng.normal(size=(150, 3)).astype(np.float32)
    dst = (src @ R.T + np.float32([0.3, -0.1, 0.05])).astype(np.float32)
    w = (rng.uniform(size=150) > 0.2).astype(np.float32)
    a, b = _both("estimate_2d", src, dst, w)
    np.testing.assert_allclose(b, a, atol=1e-6)
    np.testing.assert_allclose(b[:3, :3], R, atol=1e-5)


def test_estimate_3point_batched():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(8, 3, 3)).astype(np.float32)
    xi = rng.normal(scale=0.5, size=(8, 6)).astype(np.float32)
    T = np.asarray(jse3(jnp.asarray(xi)))
    dst = (np.einsum("bij,bkj->bki", T[:, :3, :3], src) + T[:, None, :3, 3]).astype(np.float32)
    a, b = _both("estimate_3point", src, dst)
    np.testing.assert_allclose(b, a, atol=1e-5)


@pytest.mark.parametrize("name", sorted(WARPS))
@pytest.mark.parametrize("where", ["zero", "away"])
def test_warp_and_jacobian(name, where):
    n = WARPS[name]
    p = np.zeros(n, np.float32) if where == "zero" else \
        np.random.default_rng(4).normal(scale=0.3, size=n).astype(np.float32)
    a, b = _both(name, p)
    np.testing.assert_allclose(b, a, atol=1e-6)
    jj = np.moveaxis(np.asarray(jax.jacfwd(getattr(je, name))(jnp.asarray(p))), -1, 0)
    tj = te.warp_jacobian(getattr(te, name), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(tj, jj, atol=1e-6)


@pytest.mark.parametrize("name", sorted(WARPS))
def test_estimate_lm(name):
    src, dst, w, T = _pair(outliers=20)
    n = WARPS[name]
    a = np.asarray(je.estimate_lm(*map(jnp.asarray, (src, dst, w)), warp=getattr(je, name),
                                  n_params=n))
    b = te.estimate_lm(*map(torch.from_numpy, (src, dst, w)), warp=getattr(te, name),
                       n_params=n).numpy()
    np.testing.assert_allclose(b, a, atol=1e-4 if name == "warp_rigid_3d" else 1e-5)
    if name in ("warp_rigid_6d", "warp_rigid_6d_quat"):
        np.testing.assert_allclose(b, T, atol=1e-4)
