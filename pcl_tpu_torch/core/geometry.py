"""Masked geometry primitives: means, covariance and rigid alignment.

Counterpart of the parts of ``pcl_tpu/core/geometry.py`` that ICP uses. The
rotation estimator is the JAX package's own algorithm (Horn's quaternion by
shifted power iteration plus Rayleigh-quotient inverse iteration), not an
SVD: an SVD moves the transforms at the 1e-7 level and with them ICP's
iteration counts. All functions take explicit masks or weights; padding rows
must be zero so that plain sums are masked sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS = 1e-12


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only rows where ``mask``."""
    w = mask.to(x.dtype)
    if w.ndim != x.ndim:
        shape = [1] * x.ndim
        shape[dim] = x.shape[dim]
        w = w.reshape(shape)
    num = torch.sum(x * w, dim=dim)
    den = torch.clamp(torch.sum(w, dim=dim), min=1.0)
    return num / den


def centroid(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``[..., N, 3], [..., N] -> [..., 3]`` masked centroid."""
    w = mask.to(xyz.dtype)
    num = torch.sum(xyz * w[..., None], dim=-2)
    den = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    return num / den


def mean_and_covariance(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked (optionally weighted) mean and population 3x3 covariance:
    ``(mean [..., 3], cov [..., 3, 3], weight sum [...])``."""
    w = mask.to(xyz.dtype)
    if weights is not None:
        w = w * weights
    wsum = torch.sum(w, dim=-1)
    den = torch.clamp(wsum, min=_EPS)
    mu = torch.sum(xyz * w[..., None], dim=-2) / den[..., None]
    d = (xyz - mu[..., None, :]) * w[..., None]
    cov = torch.einsum("...ni,...nj->...ij", d, xyz - mu[..., None, :]) / den[..., None, None]
    return mu, cov, wsum


def rotation_from_cross_covariance(
    H: torch.Tensor, iters: int = 16, rqi_iters: int = 3
) -> torch.Tensor:
    """Rotation R maximizing trace(R^T H) for ``H = sum w d s^T``: the top
    eigenvector of Horn's symmetric 4x4 K(H), by ``iters`` steps of shifted
    power iteration and ``rqi_iters`` steps of Rayleigh-quotient inverse
    iteration with a 1e-6 jitter. Batched over leading dims."""
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    K = torch.stack([
        torch.stack([Sxx + Syy + Szz, Szy - Syz, Sxz - Szx, Syx - Sxy], -1),
        torch.stack([Szy - Syz, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Sxz - Szx, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Syx - Sxy, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    eye4 = torch.eye(4, dtype=K.dtype, device=K.device)
    # shift so that the top eigenvalue is dominant and positive
    shift = torch.linalg.norm(K, dim=(-2, -1)) + 1e-12
    Ks = K + shift[..., None, None] * eye4
    q = K.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(K.shape[:-2] + (4,))
    for _ in range(iters):
        q = torch.einsum("...ij,...j->...i", Ks, q)
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    for _ in range(rqi_iters):
        rho = torch.einsum("...i,...ij,...j->...", q, K, q)
        A = K - rho[..., None, None] * eye4
        # regularized inverse iteration (A + eps I) y = q; A is nearly
        # singular along q near convergence, the direction it amplifies.
        # solve_ex: a failed solve gives non-finite values, caught below,
        # without a host synchronisation.
        A = A + 1e-6 * (1.0 + torch.abs(rho))[..., None, None] * eye4
        y = torch.linalg.solve_ex(A, q[..., None])[0][..., 0]
        y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=_EPS)
        s = torch.sign(torch.sum(y * q, dim=-1, keepdim=True))
        y = y * torch.where(s == 0, torch.ones_like(s), s)
        ok = torch.all(torch.isfinite(y), dim=-1, keepdim=True)
        q = torch.where(ok, y, q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def umeyama(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: torch.Tensor,
    with_scale: bool = False,
) -> torch.Tensor:
    """Weighted least-squares rigid (or similarity, ``with_scale``) transform
    ``src -> dst`` as ``[..., 4, 4]``. A zero weight removes a pair."""
    w = weights.to(src.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=_EPS)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum[..., None]
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum[..., None]
    ds = src - mu_s[..., None, :]
    dd = dst - mu_d[..., None, :]
    # 3x3 cross-covariance H = sum_i w_i dd_i ds_i^T
    H = torch.einsum("...ni,...nj->...ij", dd * w[..., None], ds)
    if with_scale:
        U, S, Vh = torch.linalg.svd(H)
        d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vh))
        D = torch.cat([torch.ones_like(S[..., :2]), d[..., None]], dim=-1)
        R = torch.einsum("...ik,...k,...kj->...ij", U, D, Vh)
        c = torch.sum(S * D, dim=-1) / torch.clamp(
            torch.sum(torch.sum(ds * ds, dim=-1) * w, dim=-1), min=_EPS)
        R = R * c[..., None, None]
    else:
        R = rotation_from_cross_covariance(H)
    t = mu_d - torch.einsum("...ij,...j->...i", R, mu_s)
    T = src.new_zeros(src.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T
