"""Statistical and radius outlier removal.

Counterpart of ``pcl_tpu/filters/outliers.py`` (PCL's
StatisticalOutlierRemoval and RadiusOutlierRemoval):

- ``statistical_outlier_removal``: each point's mean distance to its
  ``mean_k`` nearest neighbours (``search.knn``, the cell list on large
  clouds); points beyond the global mean plus ``stddev_mult`` standard
  deviations go. A point with fewer than ``mean_k`` neighbours in reach (the
  cell backend's horizon) is an outlier and stays out of the statistics.
- ``radius_outlier_removal``: points with fewer than ``min_neighbors``
  others within ``radius`` go. On large clouds a capped cell-list count
  decides every point whose buckets did not overflow or whose count already
  clears the threshold; the few others (overflowing buckets and a count
  below the threshold) are counted exactly by brute force.
"""

from __future__ import annotations

import numpy as np
import torch

from pcl_tpu_torch import search as search_mod
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.search import bruteforce, cell_list


def statistical_outlier_removal(cloud: Cloud, mean_k: int = 50, stddev_mult: float = 1.0,
                                negative: bool = False, backend: str = "auto") -> Cloud:
    """Drop points whose mean k-NN distance exceeds ``mean + stddev_mult *
    stddev`` over the points with a full neighbourhood."""
    # k + 1: the query cloud is the target, slot 0 is the point itself
    _idx, d2, valid = search_mod.knn(cloud, cloud.xyz, mean_k + 1, backend=backend)
    d = torch.sqrt(torch.clamp(d2[:, 1:], min=0.0))
    v = valid[:, 1:]
    nv = torch.sum(v, dim=1)
    # a cloud of fewer than k + 1 points gives nobody k neighbours
    required = torch.clamp(torch.sum(cloud.mask.to(torch.int64)) - 1, max=mean_k)
    enough = nv >= required
    mean_d = torch.sum(torch.where(v, d, 0.0), dim=1) / torch.clamp(nv, min=1)
    m = cloud.mask & enough
    n = torch.clamp(torch.sum(m), min=1)
    g_mean = torch.sum(torch.where(m, mean_d, 0.0)) / n
    g_var = torch.sum(torch.where(m, (mean_d - g_mean) ** 2, 0.0)) / torch.clamp(n - 1, min=1)
    keep = enough & (mean_d <= g_mean + stddev_mult * torch.sqrt(g_var))
    return cloud.with_mask(~keep if negative else keep)


def radius_outlier_keep(cloud: Cloud, radius: float, min_neighbors: int = 1,
                        backend: str = "cell", cell_cap: int = 64,
                        table_size: int = 1 << 17):
    """The decision of ``radius_outlier_removal``: ``(keep [N], ambiguous
    [N])``. ``ambiguous`` marks the points whose capped cell count truncated
    and fell below the threshold; only they need the exact count."""
    if backend == "bruteforce":
        _, _, _, count = bruteforce.radius(cloud.xyz, cloud.mask, cloud.xyz, radius, 1)
        keep = (count - 1) >= min_neighbors          # the point itself
        return keep, torch.zeros_like(keep)
    table = cell_list.build(cloud.xyz, cloud.mask, np.float32(radius),
                            table_size=table_size, cap=cell_cap)
    count, trunc = cell_list.radius_count(table, cloud.xyz, radius)
    keep = (count - 1) >= min_neighbors
    return keep, trunc & ~keep & cloud.mask


def radius_outlier_removal(cloud: Cloud, radius: float, min_neighbors: int = 1,
                           negative: bool = False, backend: str = "auto",
                           cell_cap: int = None, table_size: int = 1 << 17) -> Cloud:
    """Drop points with fewer than ``min_neighbors`` others within
    ``radius``: brute force up to 32,768 points (or ``backend="bruteforce"``),
    else the capped cell count with an exact count of the ambiguous points
    (one read-back of whether there are any)."""
    use_cells = backend == "cell" or (backend == "auto" and cloud.capacity > 32768)
    if not use_cells:
        keep, _ = radius_outlier_keep(cloud, radius, min_neighbors, backend="bruteforce")
    else:
        keep, amb = radius_outlier_keep(cloud, radius, min_neighbors, backend="cell",
                                        cell_cap=cell_cap or 64, table_size=table_size)
        if bool(torch.any(amb)):
            sel = torch.nonzero(amb)[:, 0]
            _, _, _, cnt = bruteforce.radius(cloud.xyz, cloud.mask, cloud.xyz[sel], radius, 1)
            keep = keep.index_put((sel,), (cnt - 1) >= min_neighbors)
    return cloud.with_mask(~keep if negative else keep)
