"""GASD: the globally aligned spatial distribution descriptor.

Counterpart of ``pcl_tpu/features/gasd.py`` (PCL's GASDEstimation and
GASDColorEstimation): the cloud is aligned to its PCA frame, then point
occupancy is histogrammed over a regular grid (8^3 with trilinear votes, 512
bins), or hue over a 4^3 grid of 12 hue bins (768 bins).
"""

from __future__ import annotations

import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_RGB, Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.ops.segsum import add_rows

_EPS = 1e-12


def gasd_reference_frame(cloud: Cloud, view_direction=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """The ``[4, 4]`` alignment transform (PCL's computeAlignmentTransform):
    x the largest eigenvector, z the smallest turned against the viewing
    direction, y = z x x, the centroid to the origin."""
    xyz, mask = cloud.xyz, cloud.mask
    mu, cov, _ = geometry.mean_and_covariance(xyz, mask)
    _, V = geometry.eigh33(cov)
    z, x = V[:, 0], V[:, 2]
    vd = torch.as_tensor(view_direction, dtype=xyz.dtype, device=xyz.device)
    z = torch.where(torch.dot(z, vd) > 0, -z, z)
    R = torch.stack([x, _cross(z, x), z], dim=0)
    T = torch.eye(4, dtype=xyz.dtype, device=xyz.device)
    T[:3, :3] = R
    T[:3, 3] = -R @ mu
    return T


def _aligned(cloud: Cloud):
    """The aligned points and the half side of the cube that holds them."""
    T = gasd_reference_frame(cloud)
    xyz = cloud.xyz @ T[:3, :3].T + T[:3, 3]
    r = torch.amax(torch.where(cloud.mask[:, None], xyz.abs(), 0.0))
    return xyz, torch.clamp(r, min=_EPS) * 1.0001


def estimate_gasd(cloud: Cloud, grid_size: int = 8) -> torch.Tensor:
    """Shape descriptor ``[grid_size^3]`` (512): trilinear point counts over
    the aligned cube, L1-normalised."""
    xyz, r = _aligned(cloud)
    w = cloud.mask.to(torch.float32)
    pos = (xyz / r * 0.5 + 0.5) * grid_size - 0.5
    lo = xla_int32(torch.floor(pos)).long()
    f = pos - lo
    hist = torch.zeros(grid_size ** 3, dtype=torch.float32, device=xyz.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = [torch.clamp(lo[:, i] + di, 0, grid_size - 1)
                     for i, di in enumerate((dx, dy, dz))]
                wt = (w * (f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                      * (f[:, 2] if dz else 1 - f[:, 2]))
                add_rows(hist, (c[0] * grid_size + c[1]) * grid_size + c[2], wt)
    return hist / torch.clamp(torch.sum(hist), min=_EPS)


def estimate_gasd_color(cloud: Cloud, grid_size: int = 4, hue_bins: int = 12) -> torch.Tensor:
    """Colour descriptor ``[grid_size^3 hue_bins]`` (768): a hue histogram
    per cell of the aligned grid, L1-normalised."""
    if ATTR_RGB not in cloud.attrs:
        raise ValueError("estimate_gasd_color requires 'rgb'")
    xyz, r = _aligned(cloud)
    w = cloud.mask.to(torch.float32)
    rgb = cloud.attrs[ATTR_RGB]
    mx, mn = torch.amax(rgb, dim=-1), torch.amin(rgb, dim=-1)
    c = torch.clamp(mx - mn, min=_EPS)
    r_, g_, b_ = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    h = torch.where(mx == r_, torch.remainder((g_ - b_) / c, 6.0),
                    torch.where(mx == g_, (b_ - r_) / c + 2.0, (r_ - g_) / c + 4.0))
    hb = torch.clamp((h / 6.0 * hue_bins).to(torch.int64), 0, hue_bins - 1)
    cell = torch.clamp(((xyz / r * 0.5 + 0.5) * grid_size).to(torch.int64), 0, grid_size - 1)
    flat = (cell[:, 0] * grid_size + cell[:, 1]) * grid_size + cell[:, 2]
    hist = torch.zeros(grid_size ** 3 * hue_bins, dtype=torch.float32, device=xyz.device)
    add_rows(hist, flat * hue_bins + hb, w)
    return hist / torch.clamp(torch.sum(hist), min=_EPS)
