"""Parity of pcl_tpu_torch.features.integral_normals with the JAX package on
the CPU, at the JAX tests' frame size (60 x 80, ``tests/test_features_global.py``).

Tolerances (ROADMAP C9, C26): normals ``n . n' >= 1 - 1e-5`` where the
window covariance's eigen gap allows (``lambda1 - lambda0`` above ``1e-3
lambda2`` and above 300 times the rounding of the covariance's entries,
both from a float64 recomputation; every valid pixel in gradient mode),
curvature within 1e-5 plus ten times what that rounding moves it by,
and zero normals exactly where the reference's
are zero.

The window moments are differences of float32 integral images, and
``torch.cumsum`` adds in another order than XLA (ROADMAP C25, C26), so the two
packages agree only where the frame's coordinates are small against a
window's spread: the parity scenes lie within 0.5 m of the origin, seen from
a viewpoint 3 m away. On the JAX tests' own scene, a plane 2 m away, the
covariance normals of the two packages differ by up to 86 deg on 80% of the
pixels (rounding decides them); there the port is held to the JAX tests' own
bounds against the true plane.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.features.integral_normals import integral_image_normals as j_normals

from pcl_tpu_torch.features import integral_image_normals as t_normals
from pcl_tpu_torch.features.integral_normals import _box_sum, _integral

H, W = 60, 80


def _scene(kind, rng):
    """A 60 x 80 organized frame of 1 cm pixels about the origin, with
    invalid pixels."""
    r, c = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    x, y = (c - W / 2) * 0.01, (r - H / 2) * 0.01
    if kind == "sloped":
        z = 0.5 * x
    elif kind == "bumpy":
        z = 0.05 * np.sin(9 * x) * np.cos(7 * y) + 0.2 * y
    else:                                       # two planes and a depth edge between
        z = np.where(x < 0.05, 0.3 * y, 0.1 - 0.2 * x)
    xyz = np.stack([x, y, z], -1) + rng.normal(scale=2e-4, size=(H, W, 3))
    valid = np.ones((H, W), bool)
    valid[10:20, 10:20] = False
    valid[rng.random((H, W)) < 0.03] = False
    return xyz.astype(np.float32), valid


VIEWPOINT = np.float32([0.0, 0.0, -3.0])


def _box64(a, half):
    """Window sums (float64) and the float64 integral image's entry at each
    window's far corner, which bounds the magnitude of the four entries the
    window sum takes."""
    I = np.pad(np.cumsum(np.cumsum(a, 0), 1), ((1, 0), (1, 0)) + ((0, 0),) * (a.ndim - 2))
    r, c = np.arange(H), np.arange(W)
    r0, r1 = np.clip(r - half, 0, H), np.clip(r + half + 1, 0, H)
    c0, c1 = np.clip(c - half, 0, W), np.clip(c + half + 1, 0, W)
    box = (I[r1][:, c1] - I[r0][:, c1] - I[r1][:, c0] + I[r0][:, c0])
    return box, I[r1][:, c1]


def _gap_ok(xyz, valid, half):
    """``(ok, rel)``: ``ok`` the pixels whose window covariance is decided by
    the data and not by the rounding of the float32 integral images (ROADMAP
    C9, C26):
    ``lambda1 - lambda0 > max(1e-3 lambda2, 300 delta)``, the eigenvalues of
    the window covariance in float64 and ``delta = 2^-24 (I|p|^2 + 2 |mu|
    I|p|) / cnt`` the rounding of its entries, ``I`` the integral images at
    the window's far corner; ``rel = delta / (lambda0 + lambda1 + lambda2)``,
    what that rounding moves the curvature by."""
    w = valid.astype(np.float64)
    p = xyz.astype(np.float64) * w[..., None]
    cnt = np.maximum(_box64(w, half)[0], 1.0)
    mu = _box64(p, half)[0] / cnt[..., None]
    outer = _box64(p[..., :, None] * p[..., None, :], half)[0] / cnt[..., None, None]
    lam = np.linalg.eigvalsh(outer - mu[..., :, None] * mu[..., None, :])
    i2 = _box64(np.sum(p * p, -1), half)[1]
    i1 = _box64(np.linalg.norm(p, axis=-1), half)[1]
    delta = 2.0 ** -24 * (i2 + 2 * np.linalg.norm(mu, axis=-1) * i1) / cnt
    ok = lam[..., 1] - lam[..., 0] > np.maximum(1e-3 * lam[..., 2], 300 * delta)
    return ok, delta / np.maximum(lam.sum(-1), 1e-30)


@pytest.mark.parametrize("kind", ["sloped", "bumpy", "step"])
@pytest.mark.parametrize("mode,size", [("covariance", 5), ("covariance", 9), ("gradient", 5)])
def test_integral_normals_match_jax(rng, kind, mode, size):
    xyz, valid = _scene(kind, rng)
    nj, cj = (np.asarray(a) for a in j_normals(jnp.asarray(xyz), jnp.asarray(valid),
                                               smoothing_size=size, mode=mode,
                                               viewpoint=jnp.asarray(VIEWPOINT)))
    nt, ct = (a.numpy() for a in t_normals(torch.from_numpy(xyz), torch.from_numpy(valid),
                                           smoothing_size=size, mode=mode,
                                           viewpoint=torch.from_numpy(VIEWPOINT)))
    zero_j = np.all(nj == 0, -1)
    np.testing.assert_array_equal(np.all(nt == 0, -1), zero_j)
    ok, rel = _gap_ok(xyz, valid, max(1, size // 2))
    cmp = ~zero_j & (ok if mode == "covariance" else True)
    assert cmp.mean() > 0.4          # measured 0.49-0.53 at 5 x 5, 0.92 at 9 x 9
    assert (np.sum(nt * nj, -1)[cmp] >= 1 - 1e-5).all()
    # curvature lambda0 / sum(lambda): 1e-5, plus 10 times what the rounding
    # of the integral images moves it by (lambda0 is of the order of that
    # rounding on these nearly planar windows)
    assert (np.abs(ct - cj)[cmp] <= 1e-5 + 10 * rel[cmp]).all()


@pytest.mark.parametrize("mode", ["covariance", "gradient"])
def test_viewpoint_flip_matches_jax(rng, mode):
    xyz, valid = _scene("sloped", rng)
    vp = np.float32([0.3, -0.2, 3.0])              # the other side: every normal flips
    nj = np.asarray(j_normals(jnp.asarray(xyz), jnp.asarray(valid), viewpoint=jnp.asarray(vp),
                              mode=mode)[0])
    nt = t_normals(torch.from_numpy(xyz), torch.from_numpy(valid),
                   viewpoint=torch.from_numpy(vp), mode=mode)[0].numpy()
    ok = ~np.all(nj == 0, -1) & (_gap_ok(xyz, valid, 2)[0] if mode == "covariance" else True)
    assert (np.sum(nt * nj, -1)[ok] >= 1 - 1e-5).all()
    assert (np.sum(nt * (vp - xyz), -1)[ok] >= 0).all()


@pytest.mark.parametrize("mode", ["covariance", "gradient"])
def test_jax_tests_bounds_on_their_plane(mode):
    """``tests/test_features_global.py``'s sloped plane 2 m away: the median
    normal within 0.999 of the true one, median curvature below 1e-3, and the
    invalid block zero."""
    r, c = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    x, y = (c - W / 2) * 0.01, (r - H / 2) * 0.01
    xyz = np.stack([x, y, 2.0 + 0.5 * x], -1).astype(np.float32)
    valid = np.ones((H, W), bool)
    valid[10:20, 10:20] = False
    n, curv = (a.numpy() for a in t_normals(torch.from_numpy(xyz), torch.from_numpy(valid),
                                            smoothing_size=5, mode=mode))
    expected = np.float32([-0.5, 0.0, 1.0]) / np.linalg.norm([-0.5, 0.0, 1.0])
    assert np.median(n[25:-5, 25:-5] @ -expected) > 0.999
    assert float(np.median(curv[25:-5, 25:-5])) < 1e-3
    assert (np.linalg.norm(n[12:18, 12:18], axis=-1) == 0).all()


def test_integral_image_and_box_sum():
    img = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    I = _integral(img)
    assert I.shape == (4, 5) and I[0].abs().sum() == 0 and I[:, 0].abs().sum() == 0
    assert I[3, 4] == img.sum() and I[2, 3] == img[:2, :3].sum()
    box = _box_sum(I[..., None], 1)[..., 0]
    np.testing.assert_array_equal(box.numpy()[1, 1], img[:3, :3].sum().item())
    np.testing.assert_array_equal(box.numpy()[0, 0], img[:2, :2].sum().item())


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        t_normals(torch.zeros(4, 4, 3), torch.ones(4, 4, dtype=torch.bool), mode="pca")
