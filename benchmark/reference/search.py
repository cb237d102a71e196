"""Exact neighbour searches in plain PyTorch, for the reference.

Points are sorted into a dense grid of cubic cells; a query looks at the 27
cells about its own, every point of them. Any point within one cell width of
the query lies in those cells, so a k-th neighbour found within that width is
exact; the queries whose k-th neighbour is farther (or that find fewer than k)
are searched again against every point. Distances are differences, squared and
summed in the inputs' dtype (float64 for the reference). Ties keep the lower
index, as ``torch.sort(stable=True)`` does.
"""

from __future__ import annotations

import math

import torch

_OFF27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


class Grid:
    """``points [M, 3]`` sorted by cell: ``order`` (sorted position -> point),
    the occupied cells' ids ``cells`` and their ``start`` and ``count`` in the
    sorted order."""

    def __init__(self, points: torch.Tensor, cell: float):
        self.points = points
        self.cell = float(cell)
        dev = points.device
        c = torch.floor(points / self.cell).to(torch.int64)
        self.lo = c.amin(0) - 2 if len(points) else torch.zeros(3, dtype=torch.int64, device=dev)
        hi = c.amax(0) + 2 if len(points) else torch.zeros(3, dtype=torch.int64, device=dev)
        self.span = hi - self.lo + 1
        ids = self._ids(c)
        ids_sorted, self.order = torch.sort(ids, stable=True)
        self.cells, counts = torch.unique_consecutive(ids_sorted, return_counts=True)
        self.count = counts
        self.start = torch.cumsum(counts, 0) - counts
        self.cap = int(counts.max()) if len(counts) else 0

    def _ids(self, c: torch.Tensor) -> torch.Tensor:
        r = c - self.lo
        return (r[..., 2] * self.span[1] + r[..., 1]) * self.span[0] + r[..., 0]

    def candidates(self, q: torch.Tensor):
        """``[Q, 27 * cap]`` point indices of the 27 cells about each query,
        and their validity."""
        dev = q.device
        c = torch.floor(q / self.cell).to(torch.int64)
        off = torch.tensor(_OFF27, dtype=torch.int64, device=dev)
        nb = c[:, None, :] + off[None]                                  # [Q, 27, 3]
        inside = ((nb >= self.lo) & (nb < self.lo + self.span)).all(-1)
        ids = self._ids(torch.where(inside[..., None], nb, self.lo))
        pos = torch.searchsorted(self.cells, ids)
        pos_c = torch.clamp(pos, max=max(len(self.cells) - 1, 0))
        hit = inside & (self.cells[pos_c] == ids) if len(self.cells) else inside & False
        start = torch.where(hit, self.start[pos_c], 0)
        count = torch.where(hit, self.count[pos_c], 0)
        j = torch.arange(max(self.cap, 1), device=dev)
        slot = start[..., None] + j                                      # [Q, 27, cap]
        ok = j < count[..., None]
        idx = self.order[torch.clamp(slot, max=max(len(self.order) - 1, 0))]
        return idx.reshape(len(q), -1), ok.reshape(len(q), -1)


def _brute_knn(points, queries, k):
    chunk = max(1, int(2e7) // max(len(points), 1))
    d_all, i_all = [], []
    for s in range(0, len(queries), chunk):
        q = queries[s:s + chunk]
        d2 = ((q[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        d2s, ii = torch.sort(d2, dim=1, stable=True)
        d_all.append(d2s[:, :k])
        i_all.append(ii[:, :k])
    return torch.cat(i_all), torch.cat(d_all)


def knn(points: torch.Tensor, queries: torch.Tensor, k: int, cell: float):
    """Exact ``k`` nearest neighbours: ``(idx [Q, k], d2 [Q, k])`` ascending,
    ``idx`` -1 and ``d2`` inf where the cloud has fewer than ``k`` points.
    Grids of ``cell``, then twice and four times that, each for the queries
    the one before could not settle, then every point."""
    out_i = torch.full((len(queries), k), -1, dtype=torch.int64, device=queries.device)
    out_d = torch.full((len(queries), k), math.inf, dtype=points.dtype, device=queries.device)
    k_eff = min(k, len(points))
    if k_eff == 0 or len(queries) == 0:
        return out_i, out_d
    todo = torch.arange(len(queries), device=queries.device)
    for width in (cell, 2 * cell, 4 * cell):
        if len(todo) == 0:
            break
        grid = Grid(points, width)
        chunk = max(1, int(2e7) // (27 * max(grid.cap, 1)))
        left = []
        for s in range(0, len(todo), chunk):
            rows = todo[s:s + chunk]
            q = queries[rows]
            idx, ok = grid.candidates(q)
            d2 = torch.where(ok, ((q[:, None, :] - points[idx]) ** 2).sum(-1), math.inf)
            # sort by (distance, index): the lower index first on a tie
            key_i = torch.where(ok, idx, len(points))
            ii = torch.argsort(key_i, dim=1, stable=True)
            d2, key_i = torch.gather(d2, 1, ii), torch.gather(key_i, 1, ii)
            d2s, jj = torch.sort(d2, dim=1, stable=True)
            n = min(k_eff, d2s.shape[1])
            d2s, idx = d2s[:, :n], torch.gather(key_i, 1, jj)[:, :n]
            settled = d2s[:, -1] <= width * width if n == k_eff else \
                torch.zeros(len(q), dtype=torch.bool, device=q.device)
            out_i[rows[settled], :n] = idx[settled]
            out_d[rows[settled], :n] = d2s[settled]
            left.append(rows[~settled])
        todo = torch.cat(left)
    if len(todo):
        bi, bd = _brute_knn(points, queries[todo], k_eff)
        out_i[todo, :k_eff] = bi
        out_d[todo, :k_eff] = bd
    out_i = torch.where(torch.isfinite(out_d), out_i, -1)
    return out_i, out_d


def nn1_within(points: torch.Tensor, queries: torch.Tensor, radius: float,
               first: float = 0.25):
    """Exact nearest point within ``radius``: ``(idx [Q], d2 [Q])``, -1 and
    inf where none lies within it, the lowest index among the equally near.
    A grid of ``first`` settles the queries whose nearest point lies within
    that width; one of ``radius`` the rest."""
    out_i = torch.full((len(queries),), -1, dtype=torch.int64, device=queries.device)
    out_d = torch.full((len(queries),), math.inf, dtype=points.dtype, device=queries.device)
    if len(points) == 0 or len(queries) == 0:
        return out_i, out_d
    todo = torch.arange(len(queries), device=queries.device)
    widths = (first, radius) if first < radius else (radius,)
    for width in widths:
        if len(todo) == 0:
            break
        grid = Grid(points, width)
        chunk = max(1, int(2e7) // (27 * max(grid.cap, 1)))
        left = []
        for s in range(0, len(todo), chunk):
            rows = todo[s:s + chunk]
            q = queries[rows]
            idx, ok = grid.candidates(q)
            d2 = torch.where(ok, ((q[:, None, :] - points[idx]) ** 2).sum(-1), math.inf)
            key_i = torch.where(ok, idx, len(points))
            best = torch.amin(d2, dim=1)
            i = torch.amin(torch.where(d2 == best[:, None], key_i, len(points)), dim=1)
            settled = (best <= width * width) | (width >= radius)
            inside = best <= radius * radius
            out_i[rows] = torch.where(inside, i, -1)
            out_d[rows] = torch.where(inside, best, math.inf)
            left.append(rows[~settled])
        todo = torch.cat(left)
    return out_i, out_d
