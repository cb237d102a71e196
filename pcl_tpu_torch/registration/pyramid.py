"""Pyramid feature histogram matching.

Counterpart of ``pcl_tpu/registration/pyramid.py`` (PCL's
PyramidFeatureHistogram, the Grauman-Darrell pyramid match kernel). Feature
vectors are binned at L resolutions, the bin size doubling per level; each
level is one scatter into a hashed table of fixed size, and two pyramids are
compared by the weighted sum of new matches per level, normalized by the
self-similarities.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.search.cell_list import _M32, _mul32

_PRIMES = (73856093, 19349663, 83492791, 49979687, 86028121, 15485863,
           32452843, 67867967, 49979693, 67867979, 86028157, 15485917,
           104395301, 122949823, 141650939, 160481183)


class FeaturePyramid(NamedTuple):
    tables: torch.Tensor       # [L, T] f32 hashed histogram per level
    n_features: torch.Tensor   # f32 total feature count
    n_levels: int
    n_dims: int


def _primes(d: int):
    """The multiplier of each of ``d`` dimensions: the 16 primes, then
    ``(17 .. d) * 2654435761`` wrapped to uint32."""
    extra = [(i * 2654435761) & _M32 for i in range(17, d + 1)]
    return (list(_PRIMES) + extra)[:d]


def _hash_bins(bins: torch.Tensor, table_size: int) -> torch.Tensor:
    """``[N, D]`` int bins -> ``[N]`` int32 table slot: the xor of each bin
    times its prime, in uint32 arithmetic emulated in int64 (bit for bit the
    JAX package's, negative bins wrapping as uint32)."""
    b = bins.to(torch.int64) & _M32
    h = torch.zeros(bins.shape[:-1], dtype=torch.int64, device=bins.device)
    for i, p in enumerate(_primes(bins.shape[-1])):
        h = h ^ _mul32(b[..., i], p)
    return (h % table_size).to(torch.int32)


def build_pyramid(
    features: torch.Tensor,
    mask: torch.Tensor,
    ranges: torch.Tensor,
    *,
    n_levels: int = 6,
    table_size: int = 4096,
) -> FeaturePyramid:
    """The ``n_levels``-level histogram pyramid of masked ``features [N, D]``.
    ``ranges [D, 2]`` holds each dimension's (min, max); level 0 has
    ``2^(L-1)`` bins per dimension, halving per level."""
    n, d = features.shape
    lo = ranges[:, 0]
    span = torch.clamp(ranges[:, 1] - ranges[:, 0], min=1e-12)
    w = mask.to(torch.float32)
    rel = torch.clamp((features - lo) / span, 0.0, 1.0 - 1e-7)
    tables = []
    for level in range(n_levels):
        n_bins = max(1, 2 ** (n_levels - 1 - level))
        slots = _hash_bins(xla_int32(torch.floor(rel * n_bins)), table_size)
        tables.append(add_rows(w.new_zeros(table_size), slots, w))
    return FeaturePyramid(tables=torch.stack(tables), n_features=torch.sum(w),
                          n_levels=n_levels, n_dims=d)


def _raw_match(a: FeaturePyramid, b: FeaturePyramid) -> torch.Tensor:
    """Pyramid match kernel: the sum over levels of weight times the new
    matches, the finest level (most bins) weighing 1, halving per level."""
    inter = torch.sum(torch.minimum(a.tables, b.tables), dim=-1)        # [L]
    new = inter - torch.cat([inter.new_zeros(1), inter[:-1]])
    weights = 0.5 ** torch.arange(a.n_levels, dtype=torch.float32, device=inter.device)
    return torch.sum(weights * new)


def compare_pyramids(a: FeaturePyramid, b: FeaturePyramid) -> torch.Tensor:
    """Normalized pyramid match similarity in [0, 1]."""
    m = _raw_match(a, b)
    return m / torch.clamp(torch.sqrt(_raw_match(a, a) * _raw_match(b, b)), min=1e-12)
