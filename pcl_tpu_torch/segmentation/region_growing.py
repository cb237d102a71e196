"""Region growing: smoothness-constrained components.

Counterpart of ``pcl_tpu/segmentation/region_growing.py`` (PCL's
RegionGrowing as a fixed point rather than seeded growth): an edge joins a
point to each of its ``k`` nearest neighbours whose normal lies within the
smoothness angle, usable only from a point whose curvature is below the
threshold; labels spread along the edges in both directions (a push by
scatter-min and a pull by gather) until no label changes, one flag read back
a sweep (ROADMAP C48).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_CURVATURE, ATTR_NORMAL, Cloud
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.segmentation.clustering import _compact_labels, _jump, _size_filter


def region_growing(
    cloud: Cloud,
    smoothness_threshold: float = 0.523,
    curvature_threshold: float = 0.05,
    k: int = 30,
    min_cluster_size: int = 1,
    max_cluster_size: int = 1 << 30,
    max_sweeps: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smoothness segmentation of a cloud with normals (and curvature, 0 if
    absent): ``(labels [N] int32, n_clusters)`` as ``euclidean_clusters``."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("region_growing requires normals")
    normals = cloud.attrs[ATTR_NORMAL]
    n = cloud.capacity
    dev = cloud.xyz.device
    curv = cloud.attrs.get(ATTR_CURVATURE)
    if curv is None:
        curv = torch.zeros(n, dtype=torch.float32, device=dev)
    idx, _, valid = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, k)
    idxc = torch.clamp(idx.long(), 0, n - 1)
    valid = valid & cloud.mask[:, None]
    cos_thr = float(np.cos(np.float32(smoothness_threshold)))
    smooth = torch.einsum("ni,nki->nk", normals, normals[idxc]).abs() >= cos_thr
    # growth passes only through points of low curvature
    edge = valid & smooth & (curv <= float(np.float32(curvature_threshold)))[:, None]
    mask = cloud.mask
    labels = torch.where(mask, torch.arange(n, device=dev), n)
    flat_to = idxc.reshape(-1)
    flat_ok = edge.reshape(-1)
    for _ in range(max_sweeps):
        pushed = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
            0, flat_to, torch.where(flat_ok, labels.repeat_interleave(k), n), reduce="amin")
        pulled = torch.amin(torch.where(edge, labels[idxc], n), dim=1)
        new = torch.where(mask, torch.minimum(labels, torch.minimum(pushed, pulled)), n)
        new = _jump(new, mask, n)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    dense, n_clusters = _compact_labels(labels, mask)
    return _size_filter(dense, n, min_cluster_size, max_cluster_size), n_clusters
