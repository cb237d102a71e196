"""Parity of pcl_tpu_torch.ops.batch33 with pcl_tpu.ops.batch33 on the CPU.

The JAX package works in the [9, N] lane form, the port on [N, 3, 3]: each
function runs on the same numpy matrices in both, and the JAX result comes
back through ``from_lanes``. Tolerance: 1e-6 of the largest entry of the
result (float32 rounding; the port's products are torch.matmul and einsum,
which add in another order than the lane form's written-out sums).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.ops import batch33 as jb

from pcl_tpu_torch.ops import batch33 as tb

N = 257


def _spd(rng, n=N):
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)).astype(np.float32)


def _close(got, want, tol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _lanes(a):
    return jb.to_lanes(jnp.asarray(a))


def test_layout_converters(rng):
    a = rng.normal(size=(N, 3, 3)).astype(np.float32)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    np.testing.assert_array_equal(tb.to_lanes(torch.from_numpy(a)).numpy(), np.asarray(_lanes(a)))
    np.testing.assert_array_equal(tb.from_lanes(tb.to_lanes(torch.from_numpy(a))).numpy(), a)
    np.testing.assert_array_equal(tb.vec_to_lanes(torch.from_numpy(v)).numpy(),
                                  np.asarray(jb.vec_to_lanes(jnp.asarray(v))))
    np.testing.assert_array_equal(tb.vec_from_lanes(tb.vec_to_lanes(torch.from_numpy(v))).numpy(), v)


@pytest.mark.parametrize("name", ["matmul", "matvec", "transpose", "sandwich",
                                  "add_scaled_identity", "det", "inv", "quadform",
                                  "scale", "gather"])
def test_function_matches_jax(rng, name):
    a, b = _spd(rng), rng.normal(size=(N, 3, 3)).astype(np.float32)
    x = rng.normal(size=(N, 3)).astype(np.float32)
    w = rng.uniform(size=N).astype(np.float32)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    idx = rng.integers(0, N, size=100).astype(np.int32)
    ta, tb_, tx, tw = (torch.from_numpy(v) for v in (a, b, x, w))
    if name == "matmul":
        _close(tb.matmul(ta, tb_), jb.from_lanes(jb.matmul(_lanes(a), _lanes(b))))
    elif name == "matvec":
        _close(tb.matvec(ta, tx), jb.matvec(_lanes(a), jnp.asarray(x).T).T)
    elif name == "transpose":
        np.testing.assert_array_equal(tb.transpose(tb_).numpy(),
                                      np.asarray(jb.from_lanes(jb.transpose(_lanes(b)))))
    elif name == "sandwich":
        _close(tb.sandwich(torch.from_numpy(R), ta),
               jb.from_lanes(jb.sandwich(jnp.asarray(R), _lanes(a))))
    elif name == "add_scaled_identity":
        _close(tb.add_scaled_identity(ta, 0.25),
               jb.from_lanes(jb.add_scaled_identity(_lanes(a), 0.25)))
    elif name == "det":
        _close(tb.det(ta), jb.det(_lanes(a)))
    elif name == "inv":
        got = tb.inv(ta)
        _close(got, jb.from_lanes(jb.inv(_lanes(a))))
        # and it is the inverse
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (N, 3, 3))
        np.testing.assert_allclose((ta @ got).numpy(), eye, atol=2e-3)
    elif name == "quadform":
        _close(tb.quadform(ta, tx), jb.quadform(_lanes(a), jnp.asarray(x).T))
    elif name == "scale":
        _close(tb.scale(ta, tw), jb.from_lanes(jb.scale(_lanes(a), jnp.asarray(w))))
    else:
        np.testing.assert_array_equal(tb.gather(ta, torch.from_numpy(idx)).numpy(),
                                      np.asarray(jb.from_lanes(jb.gather(_lanes(a), jnp.asarray(idx)))))


def test_inv_at_a_singular_matrix():
    """The determinant is clamped at eps with its sign (+eps at 0): finite
    entries where torch.linalg.inv would raise, the same as the JAX form."""
    a = np.zeros((4, 3, 3), np.float32)
    a[0] = np.diag([1.0, 2.0, 0.0])                     # rank 2, det = +0
    a[1] = np.outer([1, 2, 3], [1, 2, 3])               # rank 1
    a[2] = -np.eye(3)                                   # det = -1
    a[3] = np.diag([1e-12, 1e-12, 1e-12])               # det 1e-36 < eps
    got = tb.inv(torch.from_numpy(a)).numpy()
    want = np.asarray(jb.from_lanes(jb.inv(_lanes(a))))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[2], -np.eye(3), atol=1e-7)
    assert got[0, 2, 2] == pytest.approx(2.0 / 1e-30, rel=1e-6)
