"""BOARD and FLARE local reference frames.

Counterpart of ``pcl_tpu/features/lrf.py`` (PCL's
BOARDLocalReferenceFrameEstimation and FLARELocalReferenceFrameEstimation):
z is the normal of the plane fitted to the support, x points to the
neighbour whose normal tilts most from z (BOARD) or to the margin point
furthest above the tangent plane (FLARE). Frames are ``[N, 3, 3]`` with the
axes as rows, as SHOT's, with a validity mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.features.normals import normals_from_neighborhoods
from pcl_tpu_torch.search import bruteforce

_EPS = 1e-12


def _fitted_z(xyz, mask, radius, k, src_xyz=None, src_mask=None):
    """Plane-fit z axis of each query over its support radius, the
    neighbours from ``(src_xyz, src_mask)`` when given."""
    if src_xyz is None:
        src_xyz, src_mask = xyz, mask
    n = src_xyz.shape[0]
    idx, _, valid, _ = bruteforce.radius(src_xyz, src_mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, n - 1)
    valid = valid & mask[:, None]
    nbr = src_xyz[idxc]
    nrm, _ = normals_from_neighborhoods(xyz, nbr, valid, xyz.new_zeros(3))
    return nrm, idxc, valid, nbr


def _frame_towards(xyz, mask, z, valid, nbr, score):
    """x towards the neighbour of highest ``score``, projected into the
    tangent plane; ``(frames, ok)``."""
    best = torch.argmax(score, dim=1)
    tgt = nbr[torch.arange(nbr.shape[0], device=nbr.device), best]
    x = tgt - xyz
    x = x - torch.sum(x * z, dim=-1, keepdim=True) * z
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    ok = mask & (torch.sum(valid, dim=1) >= 5) & (xn[:, 0] > _EPS)
    x = x / torch.clamp(xn, min=_EPS)
    frames = torch.stack([x, _cross(z, x), z], dim=-2)
    return torch.where(ok[:, None, None], frames, 0.0), ok


def board_lrf(cloud: Cloud, radius: float, *, k: int = 64,
              surface: Optional[Cloud] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """BOARD frames ``([N, 3, 3], ok [N])``: x towards the neighbour whose
    normal tilts most from z. With ``surface`` the frames are computed at
    ``cloud``'s points from the neighbourhoods and normals of ``surface``
    (each query an exact surface point, its own normal that of its nearest
    neighbour)."""
    src = surface if surface is not None else cloud
    if ATTR_NORMAL not in src.attrs:
        raise ValueError("board_lrf requires normals")
    xyz, mask = cloud.xyz, cloud.mask
    normals = src.attrs[ATTR_NORMAL]
    z, idxc, valid, nbr = _fitted_z(
        xyz, mask, radius, k,
        src_xyz=None if surface is None else src.xyz,
        src_mask=None if surface is None else src.mask)
    own_normal = normals if surface is None else normals[idxc[:, 0]]
    z = torch.where((torch.sum(z * own_normal, dim=-1) < 0)[:, None], -z, z)
    cos_dev = torch.sum(normals[idxc] * z[:, None, :], dim=-1)
    score = torch.where(valid, 1.0 - cos_dev, -torch.inf)
    return _frame_towards(xyz, mask, z, valid, nbr, score)


def flare_lrf(cloud: Cloud, radius: float, *, margin: float = 0.85,
              k: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """FLARE frames ``([N, 3, 3], ok [N])``: x towards the support point at
    the margin (``d >= margin * radius / 2``) furthest above the tangent
    plane, over the whole support where the margin ring is empty."""
    xyz, mask = cloud.xyz, cloud.mask
    z, _, valid, nbr = _fitted_z(xyz, mask, radius, k)
    rel = nbr - xyz[:, None, :]
    d = torch.linalg.vector_norm(rel, dim=-1)
    at_margin = valid & (d >= margin * radius * 0.5)
    signed = torch.sum(rel * z[:, None, :], dim=-1)
    has_margin = torch.any(at_margin, dim=1)
    score = torch.where(has_margin[:, None], torch.where(at_margin, signed, -torch.inf),
                        torch.where(valid, signed, -torch.inf))
    return _frame_towards(xyz, mask, z, valid, nbr, score)
