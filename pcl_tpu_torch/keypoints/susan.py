"""SUSAN keypoints on normals.

Counterpart of ``pcl_tpu/keypoints/susan.py`` (PCL's SUSANKeypoint): a point
is salient when few neighbours share its normal direction (a small USAN
fraction) and the centroid of those that do lies off the point, then
non-maximum suppression over the radius, the lowest index winning a tie.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.keypoints.harris import _non_max
from pcl_tpu_torch.search import bruteforce


def susan_keypoints(
    cloud: Cloud,
    radius: float,
    angular_threshold: float = 0.2617,
    geometric_threshold: float = 0.5,
    k: int = 48,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(keypoint mask [N], response [N] = 1 - USAN fraction)``."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("susan_keypoints requires normals")
    xyz, mask = cloud.xyz, cloud.mask
    normals = cloud.attrs[ATTR_NORMAL]
    idx, _, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    valid = valid & mask[:, None]
    cos_thr = float(np.cos(np.float32(angular_threshold)))
    similar = valid & (torch.einsum("ni,nki->nk", normals, normals[idxc]).abs() >= cos_thr)
    n_nbr = torch.clamp(torch.sum(valid, dim=1), min=1)
    usan = torch.sum(similar, dim=1) / n_nbr
    response = torch.where(mask, 1.0 - usan, 0.0)
    w = similar.to(torch.float32)
    centroid = torch.einsum("nk,nki->ni", w, xyz[idxc]) / \
        torch.clamp(torch.sum(w, dim=1), min=1.0)[:, None]
    far = torch.linalg.vector_norm(centroid - xyz, dim=-1) > float(np.float32(0.1)
                                                                   * np.float32(radius))
    candidate = mask & (usan < geometric_threshold) & (n_nbr >= 5) & far
    resp = torch.where(candidate, response, -torch.inf)
    neigh_max, first = _non_max(resp, idxc, valid, torch.ones_like(mask))
    return candidate & (resp >= neigh_max) & first, response
