"""Clustered viewpoint feature histograms (CVFH, OUR-CVFH) and the camera
roll histogram (CRH).

Counterpart of ``pcl_tpu/features/cvfh.py`` (PCL's CVFHEstimation,
OURCVFHEstimation, CRHEstimation and CRHAlignment): smooth regions from
``region_growing``, one VFH per region large enough; OUR-CVFH appends each
region's roll histogram; ``crh_align`` finds the roll between two CRHs by
circular cross-correlation with ``torch.fft`` and lists the peaks by one
stable sort, the lower bin first on a tie (ROADMAP C47).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.features.global_desc import estimate_vfh
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.segmentation.region_growing import region_growing

_EPS = 1e-12


class ClusteredSignatures(NamedTuple):
    histograms: torch.Tensor     # [C_max, D] one descriptor per cluster
    centroids: torch.Tensor      # [C_max, 3]
    valid: torch.Tensor          # [C_max] bool: the cluster exists and is large enough


def _viewpoint(viewpoint, dev) -> torch.Tensor:
    return torch.zeros(3, device=dev) if viewpoint is None \
        else torch.as_tensor(viewpoint, dtype=torch.float32, device=dev)


def _cluster_masks(cloud: Cloud, max_clusters: int, eps_angle: float,
                   curvature_threshold: float, min_points: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smooth regions as ``[C_max, N]`` masks and ``[C_max]`` validity."""
    labels, _ = region_growing(cloud, smoothness_threshold=eps_angle,
                               curvature_threshold=curvature_threshold,
                               min_cluster_size=min_points)
    ids = torch.arange(max_clusters, dtype=torch.int32, device=labels.device)
    masks = labels[None, :] == ids[:, None]
    return masks, torch.sum(masks, dim=1) >= min_points


def _cvfh(cloud: Cloud, vp: torch.Tensor, masks: torch.Tensor, valid: torch.Tensor
          ) -> ClusteredSignatures:
    hists, cents = [], []
    for m in masks:
        sub = m & cloud.mask
        hists.append(estimate_vfh(Cloud(xyz=cloud.xyz, mask=sub, attrs=cloud.attrs), vp))
        w = sub.to(torch.float32)
        cents.append(torch.sum(cloud.xyz * w[:, None], dim=0) / torch.clamp(torch.sum(w),
                                                                             min=1.0))
    hists = torch.where(valid[:, None], torch.stack(hists), 0.0)
    return ClusteredSignatures(hists, torch.stack(cents), valid)


def estimate_cvfh(cloud: Cloud, viewpoint: Optional[torch.Tensor] = None, *,
                  max_clusters: int = 8, eps_angle: float = 0.13,
                  curvature_threshold: float = 0.025, min_points: int = 50
                  ) -> ClusteredSignatures:
    """CVFH: one 308-bin VFH per smooth region of at least ``min_points``,
    about the region's centroid and mean normal."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("estimate_cvfh requires normals")
    masks, valid = _cluster_masks(cloud, max_clusters, eps_angle, curvature_threshold,
                                  min_points)
    return _cvfh(cloud, _viewpoint(viewpoint, cloud.xyz.device), masks, valid)


def estimate_our_cvfh(cloud: Cloud, viewpoint: Optional[torch.Tensor] = None, *,
                      max_clusters: int = 8, eps_angle: float = 0.13,
                      curvature_threshold: float = 0.025, min_points: int = 50,
                      roll_bins: int = 90) -> ClusteredSignatures:
    """OUR-CVFH: CVFH with each region's roll histogram appended (the
    roll information of PCL's semi-global reference frame)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("estimate_cvfh requires normals")
    vp = _viewpoint(viewpoint, cloud.xyz.device)
    masks, valid = _cluster_masks(cloud, max_clusters, eps_angle, curvature_threshold,
                                  min_points)
    base = _cvfh(cloud, vp, masks, valid)
    rolls = torch.stack([estimate_crh(Cloud(xyz=cloud.xyz, mask=m & cloud.mask,
                                            attrs=cloud.attrs), vp, nbins=roll_bins)
                         for m in masks])
    hists = torch.where(valid[:, None], torch.cat([base.histograms, rolls], dim=-1), 0.0)
    return ClusteredSignatures(hists, base.centroids, valid)


def estimate_crh(cloud: Cloud, viewpoint: Optional[torch.Tensor] = None, nbins: int = 90
                 ) -> torch.Tensor:
    """Camera roll histogram ``[nbins]``: each normal projected on the plane
    orthogonal to the viewpoint-to-centroid axis, its angle there binned
    linearly between two bins and weighted by the projection's length."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("estimate_crh requires normals")
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    vp = _viewpoint(viewpoint, dev)
    normals = cloud.attrs[ATTR_NORMAL]
    w = mask.to(torch.float32)
    centroid = torch.sum(xyz * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)
    axis = centroid - vp
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis), min=_EPS)
    ref = torch.where(axis[2].abs() < 0.9, torch.tensor([0.0, 0.0, 1.0], device=dev),
                      torch.tensor([1.0, 0.0, 0.0], device=dev))
    u = _cross(ref, axis)
    u = u / torch.clamp(torch.linalg.vector_norm(u), min=_EPS)
    v = _cross(axis, u)
    nu, nv = normals @ u, normals @ v
    mag = torch.sqrt(nu * nu + nv * nv)
    pos = (torch.atan2(nv, nu) + math.pi) / (2 * math.pi) * nbins
    b0 = xla_int32(torch.floor(pos)).long() % nbins
    f = pos - torch.floor(pos)
    wt = w * mag
    hist = torch.zeros(nbins, dtype=torch.float32, device=dev)
    add_rows(hist, b0, wt * (1 - f))
    add_rows(hist, (b0 + 1) % nbins, wt * f)
    return hist / torch.clamp(torch.sum(hist), min=_EPS)


def crh_align(crh_a: torch.Tensor, crh_b: torch.Tensor, n_peaks: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Roll angles aligning histogram b onto a, by circular
    cross-correlation: ``(angles [n_peaks] rad in [-pi, pi), scores)``."""
    nbins = crh_a.shape[0]
    corr = torch.fft.irfft(torch.fft.rfft(crh_a) * torch.conj(torch.fft.rfft(crh_b)), n=nbins)
    peaks = torch.sort(-corr, stable=True)[1][:n_peaks]
    angles = peaks.to(torch.float32) / nbins * 2 * math.pi
    angles = torch.where(angles >= math.pi, angles - 2 * math.pi, angles)
    return angles, corr[peaks]
