"""Rigid-transform estimation from weighted correspondences.

Counterpart of ``pcl_tpu/registration/estimation.py``: Umeyama
(point-to-point); the point-to-plane and symmetric point-to-plane
Gauss-Newton steps solved as 6x6 normal equations and mapped through the
exact SE(3) exponential; Walker's dual-quaternion closed form; the planar
closed form; the 3-point minimal fit; and Levenberg-Marquardt over a warp
parameterization (``warp_rigid_6d``, ``warp_rigid_6d_quat``,
``warp_rigid_3d``, ``warp_translation``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.transforms import _coefficients, from_rt, hat, quat_to_matrix, se3_exp

_EPS = 1e-12


def estimate_svd(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted point-to-point closed form (Umeyama). Returns 4x4."""
    return geometry.umeyama(src, dst, weights)


def _solve_normal_equations(JtJ: torch.Tensor, Jtr: torch.Tensor) -> torch.Tensor:
    """Solve the 6x6 ``H x = -g`` with a Tikhonov term ``1e-9 trace(H)``
    for degenerate geometry. A singular system gives non-finite values,
    as in the JAX package, without a host synchronisation."""
    eye = torch.eye(JtJ.shape[-1], dtype=JtJ.dtype, device=JtJ.device)
    H = JtJ + 1e-9 * torch.trace(JtJ) * eye
    return torch.linalg.solve_ex(H, -Jtr[..., None])[0][..., 0]


def point_to_plane_system(
    src: torch.Tensor,
    dst: torch.Tensor,
    dst_normals: torch.Tensor,
    weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 6x6 point-to-plane Gauss-Newton system ``(JtJ, Jtr, sse)`` with
    residual ``r_i = n_i . (p_i - q_i)`` and ``J_i = [n_i, p_i x n_i]``
    (twist order (rho, omega), as ``se3_exp``)."""
    w = weights.to(src.dtype)
    n = dst_normals
    r = torch.sum(n * (src - dst), dim=-1)
    J = torch.cat([n, torch.linalg.cross(src, n)], dim=-1)        # [N, 6]
    Jw = J * w[:, None]
    JtJ = J.T @ Jw
    Jtr = Jw.T @ r
    sse = torch.sum(w * r * r)
    return JtJ, Jtr, sse


def estimate_point_to_plane(
    src: torch.Tensor,
    dst: torch.Tensor,
    dst_normals: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """One Gauss-Newton step on the point-to-plane metric. Returns 4x4."""
    JtJ, Jtr, _ = point_to_plane_system(src, dst, dst_normals, weights)
    return se3_exp(_solve_normal_equations(JtJ, Jtr))


def estimate_symmetric_point_to_plane(
    src: torch.Tensor,
    src_normals: torch.Tensor,
    dst: torch.Tensor,
    dst_normals: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Symmetric point-to-plane step (sum of both normals, Rusinkiewicz).
    Returns 4x4."""
    w = weights.to(src.dtype)
    n = src_normals + dst_normals
    r = torch.sum(n * (src - dst), dim=-1)
    mid = 0.5 * (src + dst)
    J = torch.cat([n, torch.linalg.cross(mid, n)], dim=-1)
    Jw = J * w[:, None]
    JtJ = J.T @ Jw
    Jtr = Jw.T @ r
    return se3_exp(_solve_normal_equations(JtJ, Jtr))


# ---------------------------------------------------------------------------
# Further closed forms
# ---------------------------------------------------------------------------

def _quat_left(q: torch.Tensor) -> torch.Tensor:
    """Left-multiplication matrix ``L(q)``: ``L(q) p = q * p`` (w, x, y, z)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], -1),
        torch.stack([x, w, -z, y], -1),
        torch.stack([y, z, w, -x], -1),
        torch.stack([z, -y, x, w], -1),
    ], -2)


def _quat_right(q: torch.Tensor) -> torch.Tensor:
    """Right-multiplication matrix ``R(q)``: ``R(q) p = p * q`` (w, x, y, z)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], -1),
        torch.stack([x, w, z, -y], -1),
        torch.stack([y, -z, w, x], -1),
        torch.stack([z, y, -x, w], -1),
    ], -2)


def estimate_dual_quaternion(src: torch.Tensor, dst: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Walker's dual-quaternion closed form with weighted sums: ``A =
    (0.25 / n) C2^T C2 - C1``, the rotation its top eigenvector (x, y, z, w;
    its sign cancels), the translation from the dual part. Returns 4x4."""
    w = weights.to(src.dtype)
    n_w = torch.clamp(torch.sum(w), min=_EPS)
    ax, ay, az = src[:, 0], src[:, 1], src[:, 2]
    bx, by, bz = dst[:, 0], dst[:, 1], dst[:, 2]

    def S(expr):
        return torch.sum(w * expr)

    axbx, ayby, azbz = S(ax * bx), S(ay * by), S(az * bz)
    axby, aybx = S(ax * by), S(ay * bx)
    axbz, azbx = S(ax * bz), S(az * bx)
    aybz, azby = S(ay * bz), S(az * by)
    C1 = torch.stack([
        torch.stack([axbx - azbz - ayby, axby + aybx, axbz + azbx, aybz - azby]),
        torch.stack([axby + aybx, ayby - azbz - axbx, azby + aybz, azbx - axbz]),
        torch.stack([axbz + azbx, azby + aybz, azbz - axbx - ayby, axby - aybx]),
        torch.stack([aybz - azby, azbx - axbz, axby - aybx, axbx + ayby + azbz]),
    ]) * (-2.0)
    p0, p1, p2 = S(ax + bx), S(ay + by), S(az + bz)     # sums of a + b
    m0, m1, m2 = S(ax - bx), S(ay - by), S(az - bz)     # sums of a - b
    zero = torch.zeros_like(p0)
    C2 = torch.stack([
        torch.stack([zero, -p2, p1, -m0]),
        torch.stack([p2, zero, -p0, -m1]),
        torch.stack([-p1, p0, zero, -m2]),
        torch.stack([m0, m1, m2, zero]),
    ]) * 2.0
    A = (0.25 / n_w) * C2.T @ C2 - C1
    _, evecs = torch.linalg.eigh(A)
    q = evecs[:, -1]                                   # (x, y, z, w)
    s = -(0.5 / n_w) * C2 @ q
    # t = s * conj(q); the translation is -vec(t)
    qw = torch.cat([q[3:4], q[:3]])                     # (w, x, y, z)
    sw = torch.cat([s[3:4], s[:3]])
    q_conj = qw * qw.new_tensor([1.0, -1.0, -1.0, -1.0])
    t_q = _quat_left(sw) @ q_conj
    return from_rt(quat_to_matrix(qw), -t_q[1:4])


def estimate_2d(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Rigid planar (x, y, yaw) closed form; z moves by the weighted mean
    offset. Returns 4x4."""
    w = weights.to(src.dtype)
    s = torch.clamp(torch.sum(w), min=_EPS)
    mu_s = torch.sum(w[:, None] * src[:, :2], dim=0) / s
    mu_d = torch.sum(w[:, None] * dst[:, :2], dim=0) / s
    a = src[:, :2] - mu_s
    b = dst[:, :2] - mu_d
    c = torch.sum(w * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]))
    sgn = torch.sum(w * (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]))
    theta = torch.arctan2(sgn, c)
    ct, st = torch.cos(theta), torch.sin(theta)
    R2 = torch.stack([torch.stack([ct, -st]), torch.stack([st, ct])])
    t2 = mu_d - R2 @ mu_s
    dz = torch.sum(w * (dst[:, 2] - src[:, 2])) / s
    one, zero = torch.ones_like(ct), torch.zeros_like(ct)
    R = torch.stack([torch.cat([R2[0], zero[None]]), torch.cat([R2[1], zero[None]]),
                     torch.stack([zero, zero, one])])
    return from_rt(R, torch.cat([t2, dz[None]]))


def estimate_3point(src3: torch.Tensor, dst3: torch.Tensor) -> torch.Tensor:
    """Exact rigid transform from three point pairs (Umeyama on the minimal
    sample); batched over leading dims."""
    return geometry.umeyama(src3, dst3, torch.ones(src3.shape[:-1], dtype=src3.dtype,
                                                   device=src3.device))


# ---------------------------------------------------------------------------
# Levenberg-Marquardt over warp parameterizations
# ---------------------------------------------------------------------------

def warp_rigid_6d(params: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` twist ``[tx, ty, tz, rx, ry, rz]`` -> ``[..., 4, 4]``
    (``se3_exp``)."""
    return se3_exp(params)


def warp_rigid_6d_quat(params: torch.Tensor) -> torch.Tensor:
    """PCL's WarpPointRigid6D: ``[..., 6]`` = ``[tx, ty, tz, qx, qy, qz]``,
    the quaternion's w recovered as ``sqrt(1 - |v|^2)`` and the quaternion
    normalized."""
    t = params[..., :3]
    v = params[..., 3:6]
    w = torch.sqrt(torch.clamp(1.0 - torch.sum(v * v, dim=-1, keepdim=True), min=0.0))
    q = torch.cat([v, w], dim=-1)                      # x, y, z, w
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    x, y, z, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - qw * z), 2 * (x * z + qw * y)], -1),
        torch.stack([2 * (x * y + qw * z), 1 - 2 * (x * x + z * z), 2 * (y * z - qw * x)], -1),
        torch.stack([2 * (x * z - qw * y), 2 * (y * z + qw * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return from_rt(R, t)


def warp_rigid_3d(params: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` = ``[tx, ty, yaw]``, a planar rigid warp."""
    zero = torch.zeros_like(params[..., 0])
    return se3_exp(torch.stack([params[..., 0], params[..., 1], zero, zero, zero,
                                params[..., 2]], -1))


def warp_translation(params: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` = ``[tx, ty, tz]``, a translation-only warp."""
    eye = torch.eye(3, dtype=params.dtype, device=params.device)
    return from_rt(eye.expand(params.shape[:-1] + (3, 3)), params)


def _tangent(dR: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4]`` derivatives of a rigid transform from those of its
    rotation and translation (the bottom row is constant: zero)."""
    top = torch.cat([dR, dt[..., None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def _se3_jacobian(xi: torch.Tensor) -> torch.Tensor:
    """``[6, 4, 4]``: the derivative of ``se3_exp(xi)`` along each twist
    coordinate, in closed form. ``R = I + A W + B W^2`` and ``t = V rho`` with
    ``V = I + B W + C W^2`` and ``A, B, C`` functions of ``s = |omega|^2``;
    their derivatives in ``s`` take the same two branches as the
    coefficients (the Taylor forms below ``s = 1e-8``), so this is the
    derivative ``jax.jacfwd`` forms there, in another order of rounding."""
    rho, w = xi[:3], xi[3:]
    s = torch.sum(w * w)
    A, B, C = _coefficients(s)
    small = s < 1e-8
    safe = torch.where(small, torch.ones_like(s), s)
    dA = torch.where(small, -1.0 / 6.0, (torch.cos(torch.sqrt(safe)) - A) / (2.0 * safe))
    dB = torch.where(small, -1.0 / 24.0, (0.5 * A - B) / safe)
    dC = torch.where(small, -1.0 / 120.0, (-dA - C) / safe)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    W = hat(w)
    W2 = W @ W
    G = hat(eye)                                      # [3, 3, 3]: d W / d omega_k
    dW2 = G @ W + W @ G
    ds = (2.0 * w)[:, None, None]
    dR = ds * (dA * W + dB * W2) + A * G + B * dW2
    dV = ds * (dB * W + dC * W2) + B * G + C * dW2
    V = eye + B * W + C * W2
    return torch.cat([_tangent(torch.zeros_like(G), V.T), _tangent(dR, dV @ rho)])


def warp_jacobian(warp: Callable[[torch.Tensor], torch.Tensor],
                  params: torch.Tensor) -> torch.Tensor:
    """``[P, 4, 4]``: the derivative of ``warp(params)`` along each parameter.
    The package's warps have closed forms (``se3_exp``'s through
    :func:`_se3_jacobian`), which spare Levenberg-Marquardt hundreds of small
    launches a step; any other warp is differentiated by
    ``torch.func.jacfwd``, forward mode as ``jax.jacfwd``, on a batch of one
    (on 0-d intermediates jacfwd forms float64 tangents, which later products
    refuse). The residuals' Jacobian follows by the chain rule, ``d(R s + t)
    = dR s + dt``, which is what ``jax.jacfwd`` of the residuals forms."""
    if warp is warp_rigid_6d:
        return _se3_jacobian(params)
    if warp is warp_rigid_3d:
        zero = torch.zeros_like(params[0])
        xi = torch.stack([params[0], params[1], zero, zero, zero, params[2]])
        J = _se3_jacobian(xi)
        return torch.cat([J[:2], J[5:]])           # slices: no index copied from the host
    if warp is warp_translation:
        eye = torch.eye(3, dtype=params.dtype, device=params.device)
        return _tangent(torch.zeros((3, 3, 3), dtype=params.dtype, device=params.device), eye)
    return torch.func.jacfwd(lambda p: warp(p[None])[0])(params).permute(2, 0, 1)


def estimate_lm(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: torch.Tensor,
    warp: Callable[[torch.Tensor], torch.Tensor] = warp_rigid_6d,
    n_params: int = 6,
    iterations: int = 10,
    init_lambda: float = 1e-3,
) -> torch.Tensor:
    """Levenberg-Marquardt over a warp parameterization from ``params = 0``:
    ``iterations`` damped Gauss-Newton steps on the per-axis residuals
    ``sqrt(w) (warp(p) src - dst)`` (3N of them: the Jacobian stays full rank
    when all offsets are parallel). A step is kept when it lowers the cost,
    and the damping then halves; otherwise it is dropped and the damping
    grows four times. Returns 4x4.

    The JAX package takes the Jacobian by ``jax.jacfwd``; here it is
    :func:`warp_jacobian`'s closed form of the warp's derivative (with the
    small-angle branch of ``se3_exp`` differentiated as there) through the
    chain rule. Every decision is a select on the device: nothing is read
    back."""
    w = weights.to(src.dtype)
    sw = torch.sqrt(w)[:, None]

    def residuals(params):
        T = warp(params)
        src_t = src @ T[:3, :3].T + T[:3, 3]
        return ((src_t - dst) * sw).reshape(-1)

    def jac(params):
        dT = warp_jacobian(warp, params)                # [P, 4, 4]
        d = torch.einsum("pij,nj->nip", dT[:, :3, :3], src) + dT[:, :3, 3].T[None]
        return (d * sw[:, :, None]).reshape(-1, n_params)

    eye = torch.eye(n_params, dtype=src.dtype, device=src.device)
    params = torch.zeros(n_params, dtype=src.dtype, device=src.device)
    lam = torch.full((), init_lambda, dtype=src.dtype, device=src.device)
    best_cost = torch.sum(residuals(params) ** 2)
    for _ in range(iterations):
        r = residuals(params)
        J = jac(params)                                # [3N, P]
        g = J.T @ r
        H = J.T @ J
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-12 * eye
        dp = torch.linalg.solve_ex(Hd, -g[:, None])[0][:, 0]
        new_params = params + dp
        new_cost = torch.sum(residuals(new_params) ** 2)
        accept = new_cost < best_cost
        params = torch.where(accept, new_params, params)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        best_cost = torch.where(accept, new_cost, best_cost)
    return warp(params)
