"""Cell-list index for bounded-radius 1-NN: the parts ICP uses.

Counterpart of ``pcl_tpu/search/cell_list.py`` (``build``,
``_neighbor_buckets``, ``nn1_radius``). The table packs each bucket into one
row of ``cap`` slots of (x, y, z, original index) floats; empty slots hold
x = y = z = 1e30. A bucket whose population exceeds ``cap`` stores every
index lane sign-encoded as ``-(idx + 1)``, so a query reads truncation from
the rows it gathered. Buckets are either a hash of the cell coordinates
(``table_size`` rows) or, with ``dims``, the row-major id of a dense grid
whose out-of-grid cells map to the extra overflow row. The JAX package's
lane-packing tricks (``_packed_sqdist``, selection matmuls) are TPU layout
work; here the same distances, ``+inf`` sentinels and truncation flags come
from ordinary ``[Q, S, 4]`` tensor ops.

The kNN and radius searches (``knn_radius``, ``radius_search``,
``radius_count``) visit the 27 cells around each query and mask candidates
of a bucket that an earlier offset already visited (hash collisions). Their
k smallest come from one stable sort of the ``[Q, S]`` candidate distances
where the JAX package runs a bitonic tournament (another TPU layout trick):
the same distances, ascending, with the earlier slot first on a tie.

Every search gathers a ``[Q, S, 4]`` candidate tensor, so each takes its
queries in chunks of at most ``_CHUNK_SLOTS`` candidate slots
(``_by_chunks``). The CSR and blocked sweeps are ported with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.search.bruteforce import smallest_k

_BIG = 1e30
_M32 = 0xFFFFFFFF
# a search gathers at most this many candidate slots (16 B each) at once
_CHUNK_SLOTS = 1 << 24

# the 27 neighbour offsets (dx outer, dz inner) and the 8 of the 2x2x2 block
_OFFSETS27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
_OFFSETS8 = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def _cell_coords(xyz: torch.Tensor, cell_size: torch.Tensor) -> torch.Tensor:
    return torch.floor(xyz / cell_size).to(torch.int32)


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """``(v * c) mod 2^32`` for ``0 <= v < 2^32`` held in int64, split into
    16-bit halves of ``c`` so that no product leaves int64."""
    lo = (v * (c & 0xFFFF)) & _M32
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(v: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche (murmur3 finalizer constants) on uint32 values held
    in int64."""
    v = v ^ (v >> 16)
    v = _mul32(v, 0x7FEB352D)
    v = v ^ (v >> 15)
    v = _mul32(v, 0x846CA68B)
    v = v ^ (v >> 16)
    return v


def _hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """``[..., 3]`` int32 cell coords -> int32 bucket in ``[0, table_size)``,
    bit-exact with the JAX package's uint32 arithmetic: each coordinate is
    wrapped to uint32, salted, avalanched, and the three are xor-ed."""
    c = coords.to(torch.int64) & _M32
    h = (_mix32(c[..., 0])
         ^ _mix32((c[..., 1] + 0x9E3779B9) & _M32)
         ^ _mix32((c[..., 2] + 0x85EBCA6B) & _M32))
    return (h % table_size).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class CellTable:
    cell_size: torch.Tensor     # 0-d f32
    table_size: int             # number of real buckets
    cap: int                    # slots per bucket
    data: torch.Tensor          # [table_size + 1, cap * 4] packed rows
    count: torch.Tensor         # [table_size + 1] int32 true populations
    dims: Optional[Tuple[int, int, int]] = None   # dense grid shape
    origin: Optional[torch.Tensor] = None         # [3] f32 dense grid corner


def _dense_id(coords: torch.Tensor, dims: Tuple[int, int, int]) -> torch.Tensor:
    """``[..., 3]`` int32 grid-relative cell coords -> row-major id; out of
    the grid -> the overflow row ``cx*cy*cz``."""
    cx, cy, cz = dims
    inb = ((coords[..., 0] >= 0) & (coords[..., 0] < cx)
           & (coords[..., 1] >= 0) & (coords[..., 1] < cy)
           & (coords[..., 2] >= 0) & (coords[..., 2] < cz))
    lin = (coords[..., 0] * cy + coords[..., 1]) * cz + coords[..., 2]
    return torch.where(inb, lin, cx * cy * cz).to(torch.int32)


def _bucket_of(table: CellTable, coords: torch.Tensor) -> torch.Tensor:
    """Cell coords -> bucket row (dense tables take grid-relative coords)."""
    if table.dims is not None:
        return _dense_id(coords, table.dims)
    return _hash(coords, table.table_size)


def _query_coords(table: CellTable, pts: torch.Tensor) -> torch.Tensor:
    """World points -> cell coords in the table's frame."""
    if table.dims is not None:
        return torch.floor((pts - table.origin) / table.cell_size).to(torch.int32)
    return _cell_coords(pts, table.cell_size)


def build(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    cell_size,
    table_size: int = 1 << 17,
    cap: int = 16,
    dims: Optional[Tuple[int, int, int]] = None,
    origin=None,
) -> CellTable:
    """Scatter the valid points into the packed bucket table.

    With ``dims`` the table is the dense grid (``table_size`` becomes
    ``prod(dims)``) anchored at ``origin``, by default the masked bounding-box
    minimum less half a cell. Original indices are stored as float32, exact
    up to 2^24 points."""
    n = xyz.shape[0]
    dev = xyz.device
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    if dims is not None:
        dims = tuple(int(d) for d in dims)
        if origin is None:
            origin = torch.amin(torch.where(mask[:, None], xyz, float("inf")), dim=0) \
                - 0.5 * cell_size
        origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
        table_size = dims[0] * dims[1] * dims[2]
        h = _dense_id(torch.floor((xyz - origin) / cell_size).to(torch.int32), dims)
    else:
        origin = None
        h = _hash(_cell_coords(xyz, cell_size), table_size)
    if (table_size + 1) * cap * 4 >= 2 ** 31:
        raise ValueError(
            f"cell table too large: (table_size+1)*cap*4 = "
            f"{(table_size + 1) * cap * 4} overflows the int32 flat scatter "
            f"index of the reference layout (table_size={table_size}, cap={cap}); "
            f"shrink dims or cap")
    h = torch.where(mask, h, table_size).to(torch.int32)      # invalid -> overflow row
    order = torch.argsort(h, stable=True)
    hs = h[order]
    start = torch.searchsorted(
        hs, torch.arange(table_size + 2, dtype=torch.int32, device=dev), right=False
    ).to(torch.int32)
    count = start[1:] - start[:-1]                             # [table_size + 1]
    hs_l = hs.long()
    rank = torch.arange(n, dtype=torch.int32, device=dev) - start[hs_l]
    keep = rank < cap
    # entries past a bucket's cap collapse onto the overflow row's slot 0
    collapse = table_size * cap
    slot = torch.where(keep, hs * cap + rank, collapse).long()
    overflowed = count[hs_l] > cap
    order_f = order.to(torch.float32)
    idx_f = torch.where(overflowed, -(1.0 + order_f), order_f)
    real = mask[order] & keep
    # collapsed and masked entries store a non-negative index lane, so that
    # probing the overflow row never reads a stale sign bit as truncation
    idx_f = torch.where(real, idx_f, 0.0)
    rows = torch.cat([torch.where(real[:, None], xyz[order], _BIG), idx_f[:, None]], dim=1)
    # Several entries may land on the collapse slot; the last of them in
    # sorted order is the one kept (sequential scatter order). The others are
    # sent to a spare row past the table, which is dropped.
    on_collapse = slot == collapse
    later = on_collapse.flip(0).cumsum(0).flip(0)       # collapsing entries from here on
    spare = (table_size + 1) * cap
    slot = torch.where(on_collapse & (later > 1), spare, slot)
    tbl = torch.full((spare + 1, 4), _BIG, dtype=torch.float32, device=dev)
    tbl[slot] = rows
    return CellTable(
        cell_size=cell_size,
        table_size=table_size,
        cap=cap,
        data=tbl[:spare].reshape(table_size + 1, cap * 4),
        count=count,
        dims=dims,
        origin=origin,
    )


def _neighbor_buckets(table: CellTable, queries: torch.Tensor, r=None) -> torch.Tensor:
    """``[Q, O]`` bucket ids of each query's cell neighbourhood: the 27
    cells around its own (``r`` None, valid when cell_size >= r), or the
    2x2x2 block anchored at ``floor((q - r) / cell)`` (valid when
    cell_size >= 2r)."""
    dev = queries.device
    if r is None:
        base = _query_coords(table, queries)
        offs = torch.tensor(_OFFSETS27, dtype=torch.int32, device=dev)
    else:
        shifted = queries - float(np.float32(r))
        if table.dims is not None:
            shifted = shifted - table.origin
        base = torch.floor(shifted / table.cell_size).to(torch.int32)
        offs = torch.tensor(_OFFSETS8, dtype=torch.int32, device=dev)
    return _bucket_of(table, base[:, None, :] + offs[None, :, :])


def _decode_idx(raw: torch.Tensor) -> torch.Tensor:
    """Undo the overflow sign encoding: ``-(idx+1) -> idx``. Lanes of empty
    slots (1e30) saturate at the int32 maximum."""
    dec = torch.where(raw < 0, -raw - 1.0, raw)
    return torch.clamp(dec, max=2.0 ** 31 - 128).to(torch.int32)


def _by_chunks(fn, queries: torch.Tensor, slots: int):
    """``fn([B, 3] queries) -> tuple of [B, ...]`` over chunks of queries
    that gather at most ``_CHUNK_SLOTS`` candidate slots (``slots`` per
    query); the outputs are concatenated."""
    step = max(1, _CHUNK_SLOTS // slots)
    parts = [fn(queries[s:s + step]) for s in range(0, max(queries.shape[0], 1), step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def nn1_radius(
    table: CellTable,
    queries: torch.Tensor,
    r,
    compact: bool = False,
    with_dst: bool = False,
):
    """Nearest neighbour within radius ``r``.

    Returns ``(idx [Q] int32, sqdist [Q] f32, truncated [Q] bool)`` and, with
    ``with_dst``, the winner's coordinates ``[Q, 3]``. ``sqdist`` is ``+inf``
    where nothing lies within ``r``. Exact unless truncated. ``compact``
    visits the 8-cell block (valid when cell_size >= 2r), otherwise the 27
    cells. Among candidates at the least distance the first slot wins, slots
    being ordered by neighbour offset and then by original index. Queries are
    processed in chunks of at most ``_CHUNK_SLOTS`` candidate slots."""
    n_off = 8 if compact else 27
    idx, d2, trunc, dst = _by_chunks(lambda q: _nn1_radius_chunk(table, q, r, compact),
                                     queries, n_off * table.cap)
    if with_dst:
        return idx, d2, trunc, dst
    return idx, d2, trunc


def _gather(table: CellTable, buckets: torch.Tensor, queries: torch.Tensor):
    """Candidate slots ``[Q, S, 4]`` of the probed buckets and their squared
    distances ``[Q, S]``, about 3e30 for an empty slot (the clamp keeps the
    1e30 sentinel's square finite)."""
    nq = queries.shape[0]
    cand = table.data[buckets.long()].reshape(nq, buckets.shape[1] * table.cap, 4)
    diff = torch.clamp(cand[..., :3] - queries[:, None, :], -1e15, 1e15)
    sq = diff * diff
    return cand, (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _r2(r) -> float:
    """The float32 square of ``r``, as the JAX package gates."""
    return float(np.float32(r) ** 2)


def _nn1_radius_chunk(table: CellTable, queries: torch.Tensor, r, compact: bool):
    nq = queries.shape[0]
    buckets = _neighbor_buckets(table, queries, r if compact else None)
    cand, d2 = _gather(table, buckets, queries)
    # empty slots land near 3e30 after the clamp: restore the +inf sentinel
    d2 = torch.where(d2 < 1e29, d2, float("inf"))
    truncated = torch.any(cand[..., 3] < 0, dim=1)
    d2 = torch.where(d2 <= _r2(r), d2, float("inf"))
    win = torch.argmin(d2, dim=1)             # the first slot at the minimum
    best_d2 = torch.gather(d2, 1, win[:, None])[:, 0]
    w = torch.gather(cand, 1, win[:, None, None].expand(nq, 1, 4))[:, 0]
    return _decode_idx(w[:, 3]), best_d2, truncated, w[:, :3]


def _dedup_mask(table: CellTable, buckets: torch.Tensor) -> torch.Tensor:
    """``[Q, O * cap]``: True on the slots of a bucket that an earlier offset
    of the same query already probed (a hash collision between offsets would
    list its points twice)."""
    n_off = buckets.shape[1]
    earlier = torch.ones((n_off, n_off), dtype=torch.bool, device=buckets.device).triu(1)
    dup = ((buckets[:, :, None] == buckets[:, None, :]) & earlier).any(dim=1)
    return dup.repeat_interleave(table.cap, dim=1)


def _candidates(table: CellTable, buckets: torch.Tensor, queries: torch.Tensor, r=None):
    """The 27-cell candidates of kNN and radius search: ``(d2 [Q, S],
    idxf [Q, S] raw index lanes, truncated [Q])``, with ``+inf`` for empty,
    out-of-radius (``r``) and duplicate slots."""
    cand, d2 = _gather(table, buckets, queries)
    d2 = torch.where(d2 < 1e29, d2, float("inf"))
    idxf = cand[..., 3]
    truncated = torch.any(idxf < 0, dim=1)
    if r is not None:
        d2 = torch.where(d2 <= _r2(r), d2, float("inf"))
    d2 = torch.where(_dedup_mask(table, buckets), float("inf"), d2)
    return d2, idxf, truncated


def _select_k(d2: torch.Tensor, idxf: torch.Tensor, k: int):
    """The ``k`` smallest candidates of each row, ascending, the earlier slot
    first on a tie, and their decoded indices."""
    dd, slot = smallest_k(d2, k)
    return dd, _decode_idx(torch.gather(idxf, 1, slot))


def knn_radius(table: CellTable, queries: torch.Tensor, k: int, r=None):
    """k nearest neighbours within the 27-cell neighbourhood (exact for the
    neighbours within ``cell_size`` when not truncated; ``r`` optionally
    tightens the radius). Returns ``(idx [Q, k] int32, sqdist [Q, k],
    valid [Q, k], truncated [Q])``."""
    def chunk(q):
        d2, idxf, truncated = _candidates(table, _neighbor_buckets(table, q), q, r)
        dd, idx = _select_k(d2, idxf, k)
        return idx, dd, torch.isfinite(dd), truncated

    return _by_chunks(chunk, queries, 27 * table.cap)


def radius_count(table: CellTable, queries: torch.Tensor, r):
    """Exact in-radius neighbour count over the 27 cells (requires
    ``cell_size >= r``; exact when no probed bucket overflows):
    ``(count [Q] int32, truncated [Q])``."""
    def chunk(q):
        buckets = _neighbor_buckets(table, q)
        cand, d2 = _gather(table, buckets, q)
        inside = (d2 <= _r2(r)) & ~_dedup_mask(table, buckets)
        return (torch.sum(inside, dim=1, dtype=torch.int32),
                torch.any(cand[..., 3] < 0, dim=1))

    return _by_chunks(chunk, queries, 27 * table.cap)


def radius_search(table: CellTable, queries: torch.Tensor, r, cap_out: int):
    """All neighbours within ``r`` (up to the ``cap_out`` nearest):
    ``(idx [Q, cap_out], sqdist, valid, count [Q], truncated [Q])``."""
    def chunk(q):
        d2, idxf, truncated = _candidates(table, _neighbor_buckets(table, q), q, r)
        count = torch.sum(torch.isfinite(d2), dim=1, dtype=torch.int32)
        dd, idx = _select_k(d2, idxf, cap_out)
        return idx, dd, torch.isfinite(dd), count, truncated

    return _by_chunks(chunk, queries, 27 * table.cap)
