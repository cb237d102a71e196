"""Rigid-transform estimation from weighted correspondences.

Counterpart of the ICP estimators in ``pcl_tpu/registration/estimation.py``:
Umeyama (point-to-point), and the point-to-plane and symmetric
point-to-plane Gauss-Newton steps solved as 6x6 normal equations and mapped
through the exact SE(3) exponential. The other estimators (dual quaternion,
2-D, LM warps) are ported with the slices that use them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.transforms import se3_exp


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
