"""Masked geometry primitives: means, covariance, 3x3 eigensystems, PCA and
rigid alignment.

Counterpart of ``pcl_tpu/core/geometry.py`` up to ``pca``. ``eigh33`` is
the JAX package's analytic closed form written as torch ops (not
``torch.linalg.eigh``), so normals follow the same formula. The rotation
estimator is the JAX package's own algorithm (Horn's quaternion by
shifted power iteration plus Rayleigh-quotient inverse iteration), not an
SVD: an SVD moves the transforms at the 1e-7 level and with them ICP's
iteration counts. All functions take explicit masks or weights; padding rows
must be zero so that plain sums are masked sums.
"""

from __future__ import annotations

import math
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


def demean(xyz: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xyz - centroid`` on valid rows, 0 elsewhere; ``centroid)``."""
    mu = centroid(xyz, mask)
    return torch.where(mask[..., None], xyz - mu[..., None, :], 0.0), mu


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _det33(B: torch.Tensor) -> torch.Tensor:
    """Determinant of ``[..., 3, 3]`` by cofactors along the first row."""
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))


def eigvals33(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric ``[..., 3, 3]``, ascending, by the analytic
    trigonometric formula (no iteration); all equal to the mean of the
    diagonal where the matrix is a multiple of the identity."""
    A = 0.5 * (A + A.transpose(-1, -2))
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    r = torch.clamp(_det33(B) / torch.clamp(2.0 * p * p * p, min=_EPS), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e3 = q + 2.0 * p * torch.cos(phi)                            # largest
    e1 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)     # smallest
    e2 = 3.0 * q - e1 - e3
    lam = torch.stack([e1, e2, e3], dim=-1)
    return torch.where((p2 < 1e-20)[..., None], q[..., None].expand_as(lam), lam)


def _eigvec(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric ``A`` for eigenvalue ``lam``: the
    largest of the row cross products of ``A - lam I``, or the x axis where
    all vanish."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    v = best / torch.sqrt(torch.clamp(torch.sum(best * best, dim=-1, keepdim=True), min=_EPS))
    degenerate = torch.maximum(torch.maximum(n01, n02), n12) < 1e-24
    fallback = torch.zeros_like(v)
    fallback[..., 0] = 1.0
    return torch.where(degenerate[..., None], fallback, v)


def _orthogonal_complement(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit vectors ``(a, b)`` spanning the plane orthogonal to unit ``v``
    (Eberly's branch-free construction)."""
    use_x = torch.abs(v[..., 0]) > torch.abs(v[..., 1])
    inv = torch.rsqrt(torch.clamp(
        torch.where(use_x, v[..., 0] * v[..., 0] + v[..., 2] * v[..., 2],
                    v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]), min=_EPS))
    zero = torch.zeros_like(inv)
    a = torch.stack([torch.where(use_x, -v[..., 2] * inv, zero),
                     torch.where(use_x, zero, v[..., 2] * inv),
                     torch.where(use_x, v[..., 0] * inv, -v[..., 1] * inv)], dim=-1)
    return a, _cross(v, a)


def eigh33(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric 3x3 eigendecomposition, the JAX package's closed
    form: ``(eigvals [..., 3] ascending, eigvecs [..., 3, 3])`` with
    ``eigvecs[..., :, k]`` the unit eigenvector of ``eigvals[..., k]``. The
    best-isolated eigenvector comes from row cross products, the other two
    from the symmetric 2x2 problem in its orthogonal plane, so the basis is
    orthonormal even for repeated eigenvalues."""
    A = 0.5 * (A + A.transpose(-1, -2))
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)), min=_EPS)
    As = A / scale[..., None, None]
    lam = eigvals33(As)
    iso_is_0 = (lam[..., 1] - lam[..., 0]) >= (lam[..., 2] - lam[..., 1])
    v_iso = _eigvec(As, torch.where(iso_is_0, lam[..., 0], lam[..., 2]))
    a, b = _orthogonal_complement(v_iso)
    Aa = torch.einsum("...ij,...j->...i", As, a)
    Ab = torch.einsum("...ij,...j->...i", As, b)
    m00 = torch.sum(a * Aa, dim=-1)
    m01 = torch.sum(a * Ab, dim=-1)
    m11 = torch.sum(b * Ab, dim=-1)
    disc = torch.sqrt(torch.clamp(0.25 * (m00 - m11) ** 2 + m01 * m01, min=0.0))
    mu = 0.5 * (m00 + m11) - disc           # the lower eigenvalue of the plane
    # its eigenvector in the plane, from the better-conditioned row
    c0a, c1a = m01, mu - m00
    c0b, c1b = mu - m11, m01
    use_a = torch.abs(c1a) + torch.abs(c0a) >= torch.abs(c1b) + torch.abs(c0b)
    c0 = torch.where(use_a, c0a, c0b)
    c1 = torch.where(use_a, c1a, c1b)
    nrm = torch.sqrt(torch.clamp(c0 * c0 + c1 * c1, min=0.0))
    degenerate = nrm < 1e-12
    c0 = torch.where(degenerate, 1.0, c0 / torch.clamp(nrm, min=_EPS))
    c1 = torch.where(degenerate, 0.0, c1 / torch.clamp(nrm, min=_EPS))
    w_lo = c0[..., None] * a + c1[..., None] * b
    w_hi = _cross(v_iso, w_lo)
    iso = iso_is_0[..., None]
    V = torch.stack([torch.where(iso, v_iso, w_lo), torch.where(iso, w_lo, w_hi),
                     torch.where(iso, w_hi, v_iso)], dim=-1)
    return lam * scale[..., None], V


def smallest_eigenvector33(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(unit eigenvector of the smallest eigenvalue, eigenvalues ascending)``."""
    lam, V = eigh33(A)
    return V[..., :, 0], lam


def pca(xyz: torch.Tensor, mask: torch.Tensor):
    """Masked PCA: ``(mean [3], eigenvalues [3] descending, eigenvectors
    [3, 3] as columns, descending)``."""
    mu, cov, _ = mean_and_covariance(xyz, mask)
    lam, V = eigh33(cov)
    return mu, lam.flip(-1), V.flip(-1)


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
