"""Voxel hash grid: the CSR spatial index.

Counterpart of ``pcl_tpu/search/hashgrid.py``. ``build`` quantises points to
integer cells, hashes each cell into a power-of-two table with the cell
list's bit-exact ``_hash``, sorts the points by bucket (a stable sort, as
``jnp.argsort`` is) and records each bucket's ``[start, end)`` in the sorted
order. A query gathers up to ``bucket_cap`` rows from each of the 27 buckets
around its cell; a bucket that an earlier offset of the same query already
visited (a hash collision between offsets) is masked, and a visited bucket
holding more than ``bucket_cap`` rows flags the query as truncated.

Exactness: ``radius(r)`` is exact for ``r <= cell_size`` and ``knn`` exact
when the k-th neighbour lies within ``cell_size``, unless truncated. The k
smallest come from one stable sort of the ``[Q, 27 * bucket_cap]`` candidate
distances (``bruteforce.smallest_k``): a tie goes to the earlier candidate
slot, as ``lax.top_k`` orders it, not to the lower point index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.search.bruteforce import smallest_k
from pcl_tpu_torch.search.cell_list import _OFFSETS27, _by_chunks, _cell_coords, _hash


@dataclasses.dataclass(frozen=True)
class HashGrid:
    cell_size: torch.Tensor      # 0-d f32
    table_size: int
    sorted_xyz: torch.Tensor     # [N, 3] points ordered by bucket
    sorted_idx: torch.Tensor     # [N] int32 original indices
    sorted_mask: torch.Tensor    # [N] validity
    bucket_start: torch.Tensor   # [table_size + 2] int32 CSR offsets


def build(xyz: torch.Tensor, mask: torch.Tensor, cell_size,
          table_size: int = 1 << 16) -> HashGrid:
    """Build the index: one stable sort of the points by bucket."""
    dev = xyz.device
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    h = _hash(_cell_coords(xyz, cell_size), table_size)
    h = torch.where(mask, h, table_size).to(torch.int32)    # invalid -> overflow bucket
    order = torch.argsort(h, stable=True)
    start = torch.searchsorted(
        h[order], torch.arange(table_size + 2, dtype=torch.int32, device=dev), right=False)
    return HashGrid(cell_size=cell_size, table_size=table_size, sorted_xyz=xyz[order],
                    sorted_idx=order.to(torch.int32), sorted_mask=mask[order],
                    bucket_start=start.to(torch.int32))


def _gather_candidates(grid: HashGrid, queries: torch.Tensor, bucket_cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(pos [Q, 27 * cap] positions in the sorted arrays, valid [Q, 27 * cap],
    truncated [Q])``: up to ``bucket_cap`` rows of each of the 27 buckets."""
    dev = queries.device
    offs = torch.tensor(_OFFSETS27, dtype=torch.int32, device=dev)
    buckets = _hash(_cell_coords(queries, grid.cell_size)[:, None, :] + offs[None], grid.table_size)
    earlier = torch.ones((27, 27), dtype=torch.bool, device=dev).triu(1)
    dup = ((buckets[:, :, None] == buckets[:, None, :]) & earlier).any(dim=1)
    b = buckets.long()
    start = grid.bucket_start[b]
    size = grid.bucket_start[b + 1] - start
    truncated = torch.any(torch.where(dup, 0, size) > bucket_cap, dim=1)
    lane = torch.arange(bucket_cap, dtype=torch.int32, device=dev)
    pos = start[:, :, None] + lane
    valid = (lane < size[:, :, None]) & ~dup[:, :, None]
    nq = queries.shape[0]
    return pos.reshape(nq, -1), valid.reshape(nq, -1), truncated


def _candidate_d2(grid: HashGrid, queries: torch.Tensor, bucket_cap: int):
    """``(d2 [Q, S] with +inf on empty, masked and duplicate slots, clipped
    positions [Q, S], truncated [Q])``."""
    pos, cvalid, truncated = _gather_candidates(grid, queries, bucket_cap)
    posc = torch.clamp(pos, 0, grid.sorted_xyz.shape[0] - 1).long()
    diff = grid.sorted_xyz[posc] - queries[:, None, :]
    sq = diff * diff
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    d = torch.where(grid.sorted_mask[posc] & cvalid, d, math.inf)
    return d, posc, truncated


def knn(grid: HashGrid, queries: torch.Tensor, k: int, bucket_cap: int = 32):
    """k-NN within the 27-cell neighbourhood: ``(idx [Q, k] int32 original
    indices, sqdist [Q, k], valid [Q, k], truncated [Q])``."""
    def chunk(q):
        d, posc, truncated = _candidate_d2(grid, q, bucket_cap)
        dd, which = smallest_k(d, k)
        idx = grid.sorted_idx[torch.gather(posc, 1, which)]
        return idx, dd, torch.isfinite(dd), truncated

    return _by_chunks(chunk, queries, 27 * bucket_cap)


def radius(grid: HashGrid, queries: torch.Tensor, r, cap: int, bucket_cap: int = 32):
    """Radius search (exact for ``r <= cell_size``): ``(idx [Q, cap], sqdist,
    valid, count [Q] in-radius candidates found, truncated [Q])``."""
    r2 = float(np.float32(r) ** 2)

    def chunk(q):
        d, posc, truncated = _candidate_d2(grid, q, bucket_cap)
        inside = d <= r2
        dd, which = smallest_k(torch.where(inside, d, math.inf), cap)
        idx = grid.sorted_idx[torch.gather(posc, 1, which)]
        return idx, dd, torch.isfinite(dd), torch.sum(inside, dim=1, dtype=torch.int32), truncated

    return _by_chunks(chunk, queries, 27 * bucket_cap)
