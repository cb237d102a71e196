"""Euclidean cluster extraction by label propagation.

Counterpart of ``pcl_tpu/segmentation/clustering.py`` (PCL's
EuclideanClusterExtraction). One radius search gives each point at most
``k`` neighbours within the tolerance; every point starts with its own index
as label and takes the smallest label among its neighbours, then its
representative's label (pointer jumping), sweep after sweep until no label
changes. The JAX package loops in ``lax.while_loop``; here the host reads
one flag back a sweep (ROADMAP C48). Labels are compacted to ``0..C-1`` in
the order of each component's smallest index, so they equal the JAX
package's exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.search import bruteforce, cell_list


def _jump(new: torch.Tensor, mask: torch.Tensor, big: int) -> torch.Tensor:
    """Adopt the label of the current representative."""
    n = new.shape[0]
    rep = new[torch.clamp(new, 0, n - 1)]
    return torch.where(mask, torch.minimum(new, rep), big)


def propagate_labels(adj: torch.Tensor, adj_valid: torch.Tensor, mask: torch.Tensor,
                     max_sweeps: int = 64) -> torch.Tensor:
    """Min-label propagation over ``adj [N, K]`` to a fixed point (or
    ``max_sweeps``): ``[N]`` int32 component labels, ``N`` where masked."""
    n = adj.shape[0]
    labels = torch.where(mask, torch.arange(n, device=adj.device), n)
    adjc = torch.clamp(adj.long(), 0, n - 1)
    for _ in range(max_sweeps):
        nbr = torch.where(adj_valid, labels[adjc], n)
        new = torch.where(mask, torch.minimum(labels, torch.amin(nbr, dim=1)), n)
        new = _jump(new, mask, n)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels.to(torch.int32)


def _compact_labels(labels: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root labels -> dense ``0..C-1`` (masked points -1): ``(dense [N]
    int32, n_clusters)``."""
    n = labels.shape[0]
    lab = labels.long()
    is_root = mask & (lab == torch.arange(n, device=labels.device))
    dense_of_root = torch.cumsum(is_root.to(torch.int64), 0) - 1
    dense = torch.where(mask, dense_of_root[torch.clamp(lab, 0, n - 1)], -1)
    return dense.to(torch.int32), torch.sum(is_root.to(torch.int32))


def labels_to_cluster_sizes(labels: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """``[N]`` dense labels -> ``[n]`` cluster sizes indexed by label."""
    n = n or labels.shape[0]
    valid = labels >= 0
    ids = torch.where(valid, labels.long(), n - 1)
    return torch.zeros(n, dtype=torch.int32, device=labels.device).index_add_(
        0, ids, valid.to(torch.int32))


def _size_filter(dense: torch.Tensor, n: int, min_cluster_size: int, max_cluster_size: int
                 ) -> torch.Tensor:
    sizes = labels_to_cluster_sizes(dense, n)
    csize = torch.where(dense >= 0, sizes[torch.clamp(dense.long(), 0, n - 1)], 0)
    keep = (csize >= min_cluster_size) & (csize <= max_cluster_size)
    return torch.where(keep, dense, -1)


def euclidean_clusters(
    cloud: Cloud,
    tolerance: float,
    min_cluster_size: int = 1,
    max_cluster_size: int = 1 << 30,
    k: int = 32,
    max_sweeps: int = 64,
    backend: str = "auto",
    table_size: int = 1 << 16,
    cell_cap: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clusters of points within ``tolerance`` of each other: ``(labels
    [N] int32, dense 0..C-1 and -1 for masked or size-filtered points,
    n_clusters before the size filter)``. ``k`` caps the neighbours a point
    sees in a sweep; the cell list carries the search above 20,000 points
    under ``backend="auto"``."""
    n = cloud.capacity
    if backend == "cell" or (backend == "auto" and n > 20_000):
        table = cell_list.build(cloud.xyz, cloud.mask, np.float32(tolerance),
                                table_size=table_size, cap=cell_cap)
        idx, _, valid, _ = cell_list.knn_radius(table, cloud.xyz, k, tolerance)
    else:
        idx, _, valid, _ = bruteforce.radius(cloud.xyz, cloud.mask, cloud.xyz, tolerance, cap=k)
    labels = propagate_labels(idx, valid & cloud.mask[:, None], cloud.mask, max_sweeps)
    dense, n_clusters = _compact_labels(labels, cloud.mask)
    return _size_filter(dense, n, min_cluster_size, max_cluster_size), n_clusters
