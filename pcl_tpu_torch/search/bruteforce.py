"""Exact brute-force neighbour search.

Counterpart of ``pcl_tpu/search/bruteforce.py``.

``nn1(target, tmask, queries) -> (index [Q] int32, sqdist [Q] f32)``, index 0
and ``+inf`` where no target is valid, the lowest index winning a tie. The
JAX package sends only large 3-D searches on the TPU to its Pallas kernel and
otherwise returns the matmul-identity distance ``q^2 + t^2 - 2 q.t``; the port
follows the kernel's contract at every size: the CUDA kernel on CUDA tensors
(3-D only, anything else raises) and its plain version on CPU tensors, both
returning the exactly recomputed ``||q - t_idx||^2``.

``knn`` and ``radius`` keep the JAX package's distance, the matmul identity
clamped at 0, computed for chunks of queries against all targets. Their
lists are ascending, and equal distances keep the lower index first (a stable
sort, as ``lax.top_k`` orders ties). Invalid slots have index 0 and ``+inf``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.ops.nn1 import nn1

__all__ = ["nn1", "knn", "radius", "smallest_k"]


def _chunk_sqdist(q: torch.Tensor, t: torch.Tensor, tmask: torch.Tensor) -> torch.Tensor:
    """``[C, 3] x [M, 3] -> [C, M]`` masked squared distances (invalid
    targets ``+inf``)."""
    q2 = torch.sum(q * q, dim=-1)
    t2 = torch.sum(t * t, dim=-1)
    d = torch.clamp(q2[:, None] + t2[None, :] - 2.0 * (q @ t.T), min=0.0)
    return torch.where(tmask[None, :], d, math.inf)


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest of each row of ``d [Q, L]``, ascending, the lower
    column first on ties (one stable sort; ``torch.topk`` leaves the order
    of ties unspecified): ``(values [Q, k], columns [Q, k] int64)``, padded
    with ``(+inf, 0)`` past ``L``. The kNN lists of every backend take it."""
    kk = min(k, d.shape[1])
    dd, col = torch.sort(d, dim=1, stable=True)
    dd, col = dd[:, :kk], col[:, :kk]
    if kk < k:
        dd = torch.nn.functional.pad(dd, (0, k - kk), value=math.inf)
        col = torch.nn.functional.pad(col, (0, k - kk))
    return dd, col


def knn(
    target: torch.Tensor,
    tmask: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact k-NN: ``(idx [Q, k] int32, sqdist [Q, k], valid [Q, k])``,
    ascending by distance."""
    parts = [smallest_k(_chunk_sqdist(queries[s:s + chunk], target, tmask), k)
             for s in range(0, max(queries.shape[0], 1), chunk)]
    dd, idx = (torch.cat(p) for p in zip(*parts))
    return idx.to(torch.int32), dd, torch.isfinite(dd)


def radius(
    target: torch.Tensor,
    tmask: torch.Tensor,
    queries: torch.Tensor,
    r: float,
    cap: int,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact radius search with a fixed result cap: ``(idx [Q, cap],
    sqdist [Q, cap], valid [Q, cap], count [Q])``, the ``cap`` nearest within
    ``r`` ascending; ``count`` is the true number within ``r`` and may exceed
    ``cap``."""
    r2 = float(np.float32(r) ** 2)
    parts = []
    for s in range(0, max(queries.shape[0], 1), chunk):
        d = _chunk_sqdist(queries[s:s + chunk], target, tmask)
        inside = d <= r2
        dd, idx = smallest_k(torch.where(inside, d, math.inf), cap)
        parts.append((idx.to(torch.int32), dd, torch.sum(inside, dim=1, dtype=torch.int32)))
    idx, dd, count = (torch.cat(p) for p in zip(*parts))
    return idx, dd, torch.isfinite(dd), count
