"""Radius-based surface descriptors: RSD and GRSD.

Counterpart of ``pcl_tpu/features/rsd.py`` (PCL's RSDEstimation and
GRSDEstimation). For a pair at distance d whose normals subtend alpha, the
osculating radius is ``d / (2 sin(alpha / 2))``; RSD keeps its minimum and
maximum over the neighbourhood, clamped to ``plane_radius``. GRSD classifies
each point by its radii into one of 5 surface types and histograms the type
pairs of neighbouring points and the type counts into 21 bins.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.features.shot import _f32
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.search import bruteforce

# GRSD surface categories (PCL's thresholds)
_NOISE, _PLANE, _CYLINDER, _SPHERE, _EDGE = 0, 1, 2, 3, 4
N_CATEGORIES = 5
GRSD_BINS = N_CATEGORIES * (N_CATEGORIES + 1) // 2 + N_CATEGORIES + 1  # 21


def estimate_rsd(cloud: Cloud, radius: float, *, plane_radius: float = 0.2, k: int = 32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point ``(r_min [N], r_max [N])`` surface radii; needs normals."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("estimate_rsd requires normals")
    xyz, mask = cloud.xyz, cloud.mask
    normals = cloud.attrs[ATTR_NORMAL]
    idx, d2, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    valid = valid & mask[:, None] & (d2 > 1e-12)       # the point itself excluded
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    cos_a = torch.clamp(torch.sum(normals[idxc] * normals[:, None, :], dim=-1), -1.0, 1.0)
    sin_half = torch.sin(0.5 * torch.arccos(cos_a))
    pr = _f32(plane_radius)
    r = torch.where(sin_half > 1e-6, d / torch.clamp(2.0 * sin_half, min=1e-12), pr)
    r = torch.clamp(r, 0.0, pr)
    has = torch.any(valid, dim=1)
    r_min = torch.where(has, torch.amin(torch.where(valid, r, torch.inf), dim=1), 0.0)
    r_max = torch.where(has, torch.amax(torch.where(valid, r, -torch.inf), dim=1), 0.0)
    return r_min, r_max


def _classify(r_min: torch.Tensor, r_max: torch.Tensor) -> torch.Tensor:
    """Surface category from the principal radii (PCL's getSimpleType
    thresholds, in metres)."""
    cat = torch.full(r_min.shape, _SPHERE, dtype=torch.int64, device=r_min.device)
    cat = torch.where(r_min > 0.100, _PLANE, cat)
    cat = torch.where((r_min < 0.015) & (r_max < 0.050), _NOISE, cat)
    cat = torch.where((r_max > 0.175) & (r_max - r_min > 0.050), _CYLINDER, cat)
    return torch.where((r_min < 0.015) & (r_max > 0.175), _EDGE, cat)


def estimate_grsd(cloud: Cloud, radius: float, *, plane_radius: float = 0.2, k: int = 32
                  ) -> torch.Tensor:
    """The global 21-bin GRSD signature: category pairs of neighbouring
    points, then the category counts, normalised to sum 1."""
    r_min, r_max = estimate_rsd(cloud, radius, plane_radius=plane_radius, k=k)
    cat = _classify(r_min, r_max)
    xyz, mask = cloud.xyz, cloud.mask
    idx, d2, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    valid = valid & mask[:, None] & (d2 > 1e-12)
    ci = cat[:, None].expand_as(idxc)
    cj = cat[idxc]
    lo, hi = torch.minimum(ci, cj), torch.maximum(ci, cj)
    pair_bin = lo * N_CATEGORIES - (lo * (lo - 1)) // 2 + (hi - lo)
    hist = torch.zeros(GRSD_BINS, dtype=torch.float32, device=xyz.device)
    add_rows(hist, pair_bin.reshape(-1), valid.to(torch.float32).reshape(-1))
    occ = torch.zeros(N_CATEGORIES, dtype=torch.float32, device=xyz.device)
    add_rows(occ, cat, mask.to(torch.float32))
    base = N_CATEGORIES * (N_CATEGORIES + 1) // 2
    hist[base:base + N_CATEGORIES] = occ
    return hist / torch.clamp(torch.sum(hist), min=1e-12)
