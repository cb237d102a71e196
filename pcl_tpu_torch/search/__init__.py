"""Unified neighbour-search API.

Counterpart of ``pcl_tpu/search/__init__.py``. Backends:

- ``bruteforce``: exact; small clouds, and 1-NN through kernel B1;
- ``cell``: the cell list (``search/cell_list.py``), exact within its cell
  horizon unless a bucket overflows ``cell_cap`` (flagged as truncated).
  ``auto`` picks it above ``_AUTO_PAIRS`` candidate pairs;
- ``hashgrid``: the CSR voxel hash (``search/hashgrid.py``), only when asked
  for.

All results are fixed-shape ``(indices, sqdists, valid[, count])``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.search import bruteforce, cell_list, hashgrid, organized
from pcl_tpu_torch.search.hashgrid import HashGrid, build as build_hashgrid
from pcl_tpu_torch.utils import trace

__all__ = ["bruteforce", "cell_list", "hashgrid", "HashGrid", "build_hashgrid", "organized",
           "knn", "radius_search", "nn1", "knn_density_radius", "auto_cell_params",
           "auto_cell_cap"]

# above this many candidate pairs (target x query capacity) the brute sweep
# gives way to the cell list; the one threshold of the search dispatch and of
# estimate_normals' density probe
_AUTO_PAIRS = 1e9
# rows of the hashed cell table that every search here builds by default, and
# on which the density probe therefore measures its cap
_TABLE_SIZE = 1 << 17


def knn_density_radius(xyz: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Radius expected to hold ~2k neighbours at uniform density over the
    masked bounding box: ``(2k * 3V / (4 pi N))^(1/3)``."""
    lo = torch.amin(torch.where(mask[:, None], xyz, float("inf")), dim=0)
    hi = torch.amax(torch.where(mask[:, None], xyz, -float("inf")), dim=0)
    vol = torch.prod(torch.clamp(hi - lo, min=1e-6))
    n = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    v = 2.0 * k * 3.0 * vol / (4.0 * np.pi * n)
    # a float64 cube root rounded once to float32 (torch has no cbrt)
    return (v.double() ** (1.0 / 3.0)).to(torch.float32)


def _occupancy_cap(x: np.ndarray, r: float, limit: int) -> int:
    """The bucket cap for points ``x`` at cell size ``r``: the fullest bucket
    of the hashed table of ``_TABLE_SIZE`` rows that ``cell_list.build`` would
    make of them (cells that share a bucket add up, as they do there), as a
    power-of-two multiple of 24 up to ``limit``."""
    cells = cell_list._cell_coords(torch.from_numpy(x), torch.tensor(r, dtype=torch.float32))
    occ = int(torch.bincount(cell_list._hash(cells, _TABLE_SIZE).long()).max())
    cap = 24
    while cap < occ and cap < limit:
        cap *= 2
    return int(min(cap, limit))


def _host_points(target) -> np.ndarray:
    """The valid points of a Cloud or ``[N, 3]`` tensor, as a host array."""
    xyz, mask = _unpack(target)
    with trace.readback("host_points"):
        x = xyz.detach().cpu().numpy()
    with trace.readback("host_points"):
        m = mask.detach().cpu().numpy()
    return x[m]


def auto_cell_params(target, k: int, cell_size: Optional[float] = None,
                     limit: int = 512, sample: int = 2000) -> Tuple[float, int]:
    """Host-side density probe: ``(cell_size, bucket_cap)`` that make the
    cell backend exact for this cloud's kNN. The cell size is the 95th
    percentile of the k-th-neighbour distance over a sample of the points
    (a scipy kd-tree on a host copy); the cap is the largest occupancy of a
    bucket of the hashed table at that size (``_TABLE_SIZE`` rows, the
    default of every search that builds one), as a power-of-two multiple of
    24 up to ``limit``. The JAX package counts cells, not buckets: two
    occupied cells that share a bucket can overflow its cap."""
    trace.count("search.probe_calls")
    with trace.span("search.auto_cell_params"):
        x = _host_points(target)
        if len(x) <= k + 1:
            return (float(cell_size) if cell_size is not None else 1.0, 24)
        if cell_size is None:
            from scipy.spatial import cKDTree
            step = max(1, len(x) // sample)
            d, _ = cKDTree(x).query(x[::step], k + 1)
            r = max(float(np.percentile(d[:, -1], 95.0)), 1e-6)
        else:
            r = float(cell_size)
        return r, _occupancy_cap(x, r, limit)


def auto_cell_cap(target, k: int, cell_size: Optional[float] = None,
                  limit: int = 512) -> int:
    """Bucket capacity that fits this cloud's measured occupancy at
    ``cell_size`` (by default the bounding-box density radius)."""
    x = _host_points(target)
    if len(x) == 0:
        return 24
    if cell_size is None:
        lo, hi = x.min(0), x.max(0)
        vol = float(np.prod(np.maximum(hi - lo, 1e-6)))
        r = float(np.cbrt(2.0 * k * 3.0 * vol / (4.0 * np.pi * len(x))))
    else:
        r = float(cell_size)
    return _occupancy_cap(x, r, limit)


def _unpack(target) -> Tuple[torch.Tensor, torch.Tensor]:
    if isinstance(target, Cloud):
        return target.xyz, target.mask
    xyz = torch.as_tensor(target, dtype=torch.float32)
    return xyz, torch.ones(xyz.shape[0], dtype=torch.bool, device=xyz.device)


def _queries(queries) -> torch.Tensor:
    return queries.xyz if isinstance(queries, Cloud) else torch.as_tensor(queries)


def knn(target, queries, k: int, backend: str = "auto",
        cell_size: Optional[float] = None, cell_cap: int = 24,
        table_size: int = _TABLE_SIZE, return_trunc: bool = False, **kw):
    """k nearest neighbours of each query: ``(idx, sqdist, valid)``, and
    ``truncated [Q]`` with ``return_trunc`` (always False on the brute
    backend). The cell backend is exact for neighbours within its horizon
    (``cell_size``, or the density radius) when no bucket truncates; the
    hash grid (``cell_size`` required, its own 2^16-bucket table; ``kw``
    may give ``bucket_cap``) likewise."""
    xyz, mask = _unpack(target)
    queries = _queries(queries)
    big = xyz.shape[0] * queries.shape[0] > _AUTO_PAIRS
    if backend == "cell" or (backend == "auto" and big):
        r = knn_density_radius(xyz, mask, k) if cell_size is None \
            else np.float32(cell_size)
        table = cell_list.build(xyz, mask, r, table_size=table_size, cap=cell_cap)
        idx, d, v, trunc = cell_list.knn_radius(table, queries, k)
    elif backend == "hashgrid":
        if cell_size is None:
            raise ValueError("hashgrid backend requires cell_size")
        idx, d, v, trunc = hashgrid.knn(build_hashgrid(xyz, mask, cell_size), queries, k, **kw)
    else:
        idx, d, v = bruteforce.knn(xyz, mask, queries, k, **kw)
        trunc = torch.zeros(queries.shape[0], dtype=torch.bool, device=queries.device)
    return (idx, d, v, trunc) if return_trunc else (idx, d, v)


def radius_search(target, queries, r: float, cap: int, backend: str = "auto",
                  cell_cap: int = 32, table_size: int = _TABLE_SIZE,
                  return_trunc: bool = False, **kw):
    """Neighbours within ``r`` (up to the ``cap`` nearest): ``(idx, sqdist,
    valid, count)``, and ``truncated [Q]`` with ``return_trunc``. The hash
    grid's cells are ``r`` wide."""
    xyz, mask = _unpack(target)
    queries = _queries(queries)
    big = xyz.shape[0] * queries.shape[0] > _AUTO_PAIRS
    if backend == "cell" or (backend == "auto" and big):
        table = cell_list.build(xyz, mask, np.float32(r), table_size=table_size,
                                cap=cell_cap)
        idx, d, v, count, trunc = cell_list.radius_search(table, queries, r, cap_out=cap)
    elif backend == "hashgrid":
        idx, d, v, count, trunc = hashgrid.radius(build_hashgrid(xyz, mask, r), queries, r,
                                                  cap, **kw)
    else:
        idx, d, v, count = bruteforce.radius(xyz, mask, queries, r, cap, **kw)
        trunc = torch.zeros(queries.shape[0], dtype=torch.bool, device=queries.device)
    return (idx, d, v, count, trunc) if return_trunc else (idx, d, v, count)


def nn1(target, queries, **kw):
    """Exact nearest neighbour: ``(idx, sqdist)``."""
    xyz, mask = _unpack(target)
    return bruteforce.nn1(xyz, mask, _queries(queries), **kw)
