"""Smoothed-surfaces keypoints.

Counterpart of ``pcl_tpu/keypoints/smoothed.py`` (PCL's
SmoothedSurfacesKeypoint): given a cloud and index-aligned smoothed copies
of it (MLS at growing radii, say), a point is a keypoint where its
along-normal displacement between consecutive scales is a local extremum of
its neighbourhood (the ``k`` nearest within ``neighborhood_radius``, the
point itself among them) at every scale, and some displacement exceeds
``min_displacement``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.search import bruteforce


def _extrema(xyz: torch.Tensor, mask: torch.Tensor, diffs: torch.Tensor, k: int,
             neighborhood_radius: float) -> torch.Tensor:
    idx, d2, ok = bruteforce.knn(xyz, mask, xyz, k)
    r32 = np.float32(neighborhood_radius)
    ok = ok & (d2 <= float(r32 * r32)) & mask[:, None]
    idxc = torch.clamp(idx.long(), 0, xyz.shape[0] - 1)
    keypoint = mask
    for dv in diffs:
        nb = dv[idxc]
        is_max = dv >= torch.amax(torch.where(ok, nb, -torch.inf), dim=1)
        is_min = dv <= torch.amin(torch.where(ok, nb, torch.inf), dim=1)
        keypoint = keypoint & (is_max | is_min)
    return keypoint


def smoothed_surfaces_keypoints(cloud: Cloud, smoothed_clouds: Sequence[Cloud],
                                neighborhood_radius: float, k: int = 16,
                                min_displacement: float = 1e-4) -> np.ndarray:
    """``[N]`` bool keypoint mask (host numpy, as the JAX package returns)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("smoothed_surfaces_keypoints requires normals")
    n = cloud.attrs[ATTR_NORMAL]
    prev = cloud.xyz
    diffs = []
    for sc in smoothed_clouds:
        diffs.append(torch.sum((sc.xyz - prev) * n, dim=-1))
        prev = sc.xyz
    D = torch.stack(diffs)
    kp = _extrema(cloud.xyz, cloud.mask, D, k, neighborhood_radius)
    big_enough = torch.amax(torch.abs(D), dim=0) > min_displacement
    return (kp & big_enough).cpu().numpy()
