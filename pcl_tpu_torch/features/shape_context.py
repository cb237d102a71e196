"""3-D shape context descriptors: 3DSC and USC.

Counterpart of ``pcl_tpu/features/shape_context.py`` (PCL's
ShapeContext3DEstimation and UniqueShapeContext): a log-radial x elevation x
azimuth histogram (15 x 11 x 12 = 1980 bins by default) of density-weighted
neighbour counts. 3DSC's z axis is the normal and its azimuth origin a random
tangent direction; USC anchors the grid to SHOT's local reference frame.

3DSC is a sampler and a core (ROADMAP C17, C50): ``draw_3dsc_axes`` draws the
``[N, 3]`` normal deviates whose tangent component gives each azimuth
origin, ``estimate_3dsc_core`` takes them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.features.shot import _f32, _scatter_rows, local_reference_frames
from pcl_tpu_torch.search import bruteforce

_EPS = 1e-12


def _sc_histogram(rel, valid, min_radius, radius, radial_bins, elevation_bins, azimuth_bins):
    """Shape-context binning of ``rel [N, k, 3]`` (neighbour offsets in the
    local frame): log-spaced radial shells, elevation from +z, azimuth about
    z, each neighbour weighted ``1 / (count * cbrt(bin volume))``;
    L2-normalised rows."""
    dev = rel.device
    d = torch.linalg.vector_norm(rel, dim=-1)
    inside = valid & (d > min_radius) & (d <= radius)
    j = torch.arange(radial_bins + 1, dtype=torch.float32, device=dev)
    lmin = torch.log(torch.tensor(min_radius, dtype=torch.float32, device=dev))
    lmax = torch.log(torch.tensor(radius, dtype=torch.float32, device=dev))
    edges = torch.exp(lmin + (j / radial_bins) * (lmax - lmin))
    rbin = torch.clamp(torch.searchsorted(edges, d.contiguous(), right=True) - 1,
                       0, radial_bins - 1)
    el = torch.arccos(torch.clamp(rel[..., 2] / torch.clamp(d, min=_EPS), -1.0, 1.0))
    ebin = torch.clamp((el / math.pi * elevation_bins).to(torch.int64), 0, elevation_bins - 1)
    az = torch.atan2(rel[..., 1], rel[..., 0]) + math.pi
    abin = torch.clamp((az / (2 * math.pi) * azimuth_bins).to(torch.int64), 0, azimuth_bins - 1)
    flat = (rbin * elevation_bins + ebin) * azimuth_bins + abin
    shell_vol = edges[1:] ** 3 - edges[:-1] ** 3
    vol = shell_vol[rbin] / (elevation_bins * azimuth_bins)
    local_cnt = torch.clamp(torch.sum(inside, dim=1, keepdim=True), min=1)
    # a float64 cube root rounded once to float32 (torch has no cbrt)
    cbrt = (torch.clamp(vol, min=_EPS).double() ** (1.0 / 3.0)).to(torch.float32)
    w = torch.where(inside, 1.0 / (local_cnt * cbrt), 0.0)
    hist = _scatter_rows(flat, w, radial_bins * elevation_bins * azimuth_bins)
    return hist / torch.clamp(torch.linalg.vector_norm(hist, dim=1, keepdim=True), min=_EPS)


def _radii(radius, min_radius):
    """The two radii as the JAX package's traced float32 scalars."""
    r = np.float32(radius)
    mr = np.float32(0.1) * r if min_radius is None else np.float32(min_radius)
    return float(r), float(mr)


def draw_3dsc_axes(n: int, device=None, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[n, 3]`` standard normal deviates (3DSC's random azimuth origins),
    from ``gen`` (seeded 0 on ``device`` unless given)."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((n, 3), generator=gen, device=gen.device)


def estimate_3dsc_core(
    cloud: Cloud,
    radius: float,
    rnd: torch.Tensor,
    *,
    min_radius: Optional[float] = None,
    k: int = 64,
    radial_bins: int = 15,
    elevation_bins: int = 11,
    azimuth_bins: int = 12,
) -> torch.Tensor:
    """3DSC ``[N, 1980]`` with the azimuth origin of each point the tangent
    component of ``rnd [N, 3]``; z is the point's normal."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("estimate_3dsc requires normals")
    r, mr = _radii(radius, min_radius)
    xyz, mask = cloud.xyz, cloud.mask
    z = cloud.attrs[ATTR_NORMAL]
    idx, d2, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    valid = valid & mask[:, None] & (d2 > _EPS)
    rel_w = xyz[idxc] - xyz[:, None, :]
    rnd = rnd.to(device=xyz.device, dtype=torch.float32)
    x = rnd - torch.sum(rnd * z, dim=-1, keepdim=True) * z
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=_EPS)
    R = torch.stack([x, _cross(z, x), z], dim=-2)
    rel = torch.einsum("nij,nkj->nki", R, rel_w)
    return _sc_histogram(rel, valid, mr, r, radial_bins, elevation_bins, azimuth_bins)


def estimate_3dsc(
    cloud: Cloud,
    radius: float,
    *,
    min_radius: Optional[float] = None,
    k: int = 64,
    radial_bins: int = 15,
    elevation_bins: int = 11,
    azimuth_bins: int = 12,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """3DSC ``[N, 1980]`` (min_radius 0.1 radius by default): the azimuth
    origins drawn from ``gen``, then ``estimate_3dsc_core``."""
    rnd = draw_3dsc_axes(cloud.capacity, cloud.xyz.device, gen)
    return estimate_3dsc_core(cloud, radius, rnd, min_radius=min_radius, k=k,
                              radial_bins=radial_bins, elevation_bins=elevation_bins,
                              azimuth_bins=azimuth_bins)


def estimate_usc(
    cloud: Cloud,
    radius: float,
    *,
    min_radius: Optional[float] = None,
    lrf_radius: Optional[float] = None,
    k: int = 64,
    radial_bins: int = 15,
    elevation_bins: int = 11,
    azimuth_bins: int = 12,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """USC: the shape context in SHOT's local reference frame (no random
    azimuth): ``(descriptors [N, 1980], frames [N, 3, 3])``."""
    r, mr = _radii(radius, min_radius)
    lrf_r = r if lrf_radius is None else _f32(lrf_radius)
    xyz, mask = cloud.xyz, cloud.mask
    idx, d2, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    valid = valid & mask[:, None] & (d2 > _EPS)
    nbr = xyz[idxc]
    frames, ok = local_reference_frames(xyz, nbr, valid, lrf_r)
    rel = torch.einsum("nij,nkj->nki", frames, nbr - xyz[:, None, :])
    hist = _sc_histogram(rel, valid, mr, r, radial_bins, elevation_bins, azimuth_bins)
    return torch.where((mask & ok)[:, None], hist, 0.0), frames
