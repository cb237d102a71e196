"""Intensity descriptors: gradient, intensity spin image and RIFT.

Counterpart of ``pcl_tpu/features/intensity.py`` (PCL's
IntensityGradientEstimation, IntensitySpinEstimation and RIFTEstimation):
the least-squares intensity gradient of each neighbourhood in its tangent
plane; a Gaussian-smoothed histogram over (distance, intensity); and a
bilinear histogram over (distance, angle between the neighbour's gradient
and the outward radial direction), weighted by the gradient's magnitude.
"""

from __future__ import annotations

import math

import torch

from pcl_tpu_torch.core.cloud import ATTR_INTENSITY, ATTR_NORMAL, Cloud
from pcl_tpu_torch.features.shot import _f32
from pcl_tpu_torch.search import bruteforce

_EPS = 1e-12


def _radius_nbrs(cloud: Cloud, radius: float, k: int):
    idx, d2, valid, _ = bruteforce.radius(cloud.xyz, cloud.mask, cloud.xyz, radius, cap=k)
    return torch.clamp(idx.long(), 0, cloud.capacity - 1), d2, valid & cloud.mask[:, None]


def _normalise_rows(hist: torch.Tensor) -> torch.Tensor:
    hist = hist.reshape(hist.shape[0], -1)
    return hist / torch.clamp(torch.sum(hist, dim=1, keepdim=True), min=_EPS)


def intensity_gradient(cloud: Cloud, radius: float, *, k: int = 32) -> torch.Tensor:
    """Per-point intensity gradient ``[N, 3]`` in the tangent plane: the
    3x3 normal equations of a linear intensity model (regularised by 1e-9),
    the normal component removed; 0 with fewer than 3 neighbours."""
    if ATTR_INTENSITY not in cloud.attrs:
        raise ValueError("intensity_gradient requires 'intensity'")
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("intensity_gradient requires 'normal'")
    inten = cloud.attrs[ATTR_INTENSITY]
    normals = cloud.attrs[ATTR_NORMAL]
    idxc, _, valid = _radius_nbrs(cloud, radius, k)
    w = valid.to(torch.float32)
    wsum = torch.clamp(torch.sum(w, dim=1), min=1.0)
    nbr, nbr_i = cloud.xyz[idxc], inten[idxc]
    mu_p = torch.einsum("nk,nki->ni", w, nbr) / wsum[:, None]
    mu_i = torch.sum(w * nbr_i, dim=1) / wsum
    dp = (nbr - mu_p[:, None, :]) * w[..., None]
    di = (nbr_i - mu_i[:, None]) * w
    A = torch.einsum("nki,nkj->nij", dp, dp) + 1e-9 * torch.eye(3, device=dp.device)
    b = torch.einsum("nki,nk->ni", dp, di)
    g = torch.linalg.solve(A, b[..., None])[..., 0]
    g = g - torch.sum(g * normals, dim=-1, keepdim=True) * normals
    ok = cloud.mask & (torch.sum(w, dim=1) >= 3)
    return torch.where(ok[:, None], g, 0.0)


def intensity_spin(cloud: Cloud, radius: float, *, k: int = 32, distance_bins: int = 4,
                   intensity_bins: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Intensity spin images ``[N, distance_bins intensity_bins]``: Gaussian
    votes (``sigma`` in bins) over normalised distance and the intensity
    relative to the cloud's range, rows summing to 1."""
    if ATTR_INTENSITY not in cloud.attrs:
        raise ValueError("intensity_spin requires 'intensity'")
    mask = cloud.mask
    inten = cloud.attrs[ATTR_INTENSITY]
    idxc, d2, valid = _radius_nbrs(cloud, radius, k)
    w = valid.to(torch.float32)
    d = torch.sqrt(torch.clamp(d2, min=0.0)) / _f32(radius)
    i_min = torch.amin(torch.where(mask, inten, torch.inf))
    i_max = torch.amax(torch.where(mask, inten, -torch.inf))
    i_rel = (inten[idxc] - i_min) / torch.clamp(i_max - i_min, min=_EPS)
    db = torch.arange(distance_bins, dtype=torch.float32, device=d.device)
    ib = torch.arange(intensity_bins, dtype=torch.float32, device=d.device)
    s = _f32(sigma)
    wd = torch.exp(-0.5 * (((d * distance_bins - 0.5)[..., None] - db) / s) ** 2)
    wi = torch.exp(-0.5 * (((i_rel * intensity_bins - 0.5)[..., None] - ib) / s) ** 2)
    return _normalise_rows(torch.einsum("nk,nkd,nki->ndi", w, wd, wi))


def rift(cloud: Cloud, radius: float, gradients: torch.Tensor, *, k: int = 32,
         distance_bins: int = 4, gradient_bins: int = 8) -> torch.Tensor:
    """RIFT ``[N, distance_bins gradient_bins]`` from per-point
    ``gradients [N, 3]``: bilinear votes at (normalised distance, angle
    between gradient and outward direction), weighted by the gradient's
    norm, rows summing to 1."""
    idxc, d2, valid = _radius_nbrs(cloud, radius, k)
    valid = valid & (d2 > _EPS)
    rel = cloud.xyz[idxc] - cloud.xyz[:, None, :]
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    radial = rel / torch.clamp(d, min=_EPS)[..., None]
    g = gradients[idxc]
    g_norm = torch.linalg.vector_norm(g, dim=-1)
    g_unit = g / torch.clamp(g_norm, min=_EPS)[..., None]
    theta = torch.arccos(torch.clamp(torch.sum(g_unit * radial, dim=-1), -1.0, 1.0))
    w = valid.to(torch.float32) * g_norm
    d_pos = (d / _f32(radius)) * distance_bins - 0.5
    t_pos = (theta / math.pi) * gradient_bins - 0.5
    db = torch.arange(distance_bins, dtype=torch.float32, device=d.device)
    tb = torch.arange(gradient_bins, dtype=torch.float32, device=d.device)
    wd = torch.clamp(1.0 - (d_pos[..., None] - db).abs(), min=0.0)
    wt = torch.clamp(1.0 - (t_pos[..., None] - tb).abs(), min=0.0)
    return _normalise_rows(torch.einsum("nk,nkd,nkt->ndt", w, wd, wt))
