"""Exact brute-force neighbour search.

Counterpart of ``pcl_tpu/search/bruteforce.py``.

``nn1(target, tmask, queries) -> (index [Q] int32, sqdist [Q] f32)``, index 0
and ``+inf`` where no target is valid, the lowest index winning a tie. The
JAX package sends only large 3-D searches on the TPU to its Pallas kernel and
otherwise returns the matmul-identity distance ``q^2 + t^2 - 2 q.t``. The port
follows the kernel's contract for 3-D searches at every size: the CUDA kernel
on CUDA tensors and its plain version on CPU tensors, both returning the
exactly recomputed ``||q - t_idx||^2``. Any other width (the 6-D xyz + Lab
search of ``gicp6d``) never reaches a kernel in the JAX package either: it
takes the chunked matmul-identity sweep here as there, on both devices.

``knn`` and ``radius`` keep the JAX package's distance, the matmul identity
clamped at 0, computed for chunks of queries against all targets; in 3-D
bit for bit (``_chunk_sqdist``, ROADMAP F2). Their lists are ascending, and
equal distances keep the lower index first (a stable sort, as ``lax.top_k``
orders ties). Invalid slots have index 0 and ``+inf``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.ops import nn1 as _nn1_kernel

__all__ = ["nn1", "knn", "radius", "smallest_k"]


def _fma_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_k a[..., k] * b[..., k]`` (broadcast) as the JAX package's
    compiled CPU code forms it: ``a_0 b_0``, then one fused multiply-add per
    further coordinate in ascending order, each emulated in float64 and
    rounded once to float32 (as ``ops.nn1`` does)."""
    out = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        out = _nn1_kernel._fma32(a[..., k], b[..., k], out)
    return out


def _chunk_sqdist(q: torch.Tensor, t: torch.Tensor, tmask: torch.Tensor) -> torch.Tensor:
    """``[C, D] x [M, D] -> [C, M]`` masked squared distances (invalid
    targets ``+inf``): the matmul identity ``(q^2 + t^2) - 2 q.t`` clamped at
    0. In 3-D the norms and the dot products are fused multiply-add chains,
    bit for bit as the JAX package's compiled CPU path computes them, so a
    point lies exactly 0 from itself; a BLAS product next to plainly summed
    norms leaves some points ~1e-6 from themselves, which FPFH's ``1 / d^2``
    weight turns into its largest term. Other widths take a matrix product."""
    if q.shape[1] == 3:
        dot = _fma_sum(q[:, None, :], t[None, :, :])
        q2, t2 = _fma_sum(q, q), _fma_sum(t, t)
    else:
        dot = q @ t.T
        q2, t2 = torch.sum(q * q, dim=-1), torch.sum(t * t, dim=-1)
    d = torch.clamp((q2[:, None] + t2[None, :]) - 2.0 * dot, min=0.0)
    return torch.where(tmask[None, :], d, math.inf)


def nn1(
    target: torch.Tensor,
    tmask: torch.Tensor,
    queries: torch.Tensor,
    chunk: int = 2048,
    tile: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: ``(index [Q] int32, sqdist [Q] f32)``.

    3-D searches go to kernel B1's wrapper (``ops.nn1.nn1``: exact
    distances), made contiguous first (the wrapper takes no strides; a
    voxel grid's xyz is a column slice of its sums). Other widths sweep
    ``chunk`` queries against ``tile`` targets at a time with the
    matmul-identity distance; a later tile wins only on strictly less, so
    the lowest index wins a tie."""
    if queries.shape[-1] == 3:
        return _nn1_kernel.nn1(target.contiguous(), tmask.contiguous(), queries.contiguous())
    dev = queries.device
    parts = []
    for s in range(0, max(queries.shape[0], 1), chunk):
        qc = queries[s:s + chunk]
        best_d = torch.full((qc.shape[0],), math.inf, dtype=torch.float32, device=dev)
        best_i = torch.zeros(qc.shape[0], dtype=torch.int64, device=dev)
        for m in range(0, target.shape[0], tile):
            d = _chunk_sqdist(qc, target[m:m + tile], tmask[m:m + tile])
            dj, j = torch.min(d, dim=1)           # the first column at the minimum
            better = dj < best_d
            best_d = torch.where(better, dj, best_d)
            best_i = torch.where(better, j + m, best_i)
        parts.append((best_i.to(torch.int32), best_d))
    idx, dd = (torch.cat(p) for p in zip(*parts))
    return idx, dd


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest of each row of ``d [Q, L]``, ascending, the lower
    column first on ties, NaN last (``torch.sort(stable=True)``'s first
    ``k``; ``torch.topk`` leaves the order of ties unspecified): ``(values
    [Q, k], columns [Q, k] int64)``, padded with ``(+inf, 0)`` past ``L``.
    The kNN lists of every backend take it. One ``topk`` of unique int64
    keys, the value's order-preserving bits above the column, costs a
    partial selection where a sort of every row would cost ``L log L``."""
    kk = min(k, d.shape[1])
    v = torch.where(torch.isnan(d), math.nan, d + 0.0)      # one NaN, and no -0.0
    bits = v.view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)   # negatives in float order
    key = (bits << 32) | torch.arange(d.shape[1], dtype=torch.int64, device=d.device)
    col = torch.topk(key, kk, dim=1, largest=False, sorted=True)[0] & 0xFFFFFFFF
    dd = torch.gather(d, 1, col)
    if kk < k:
        dd = torch.nn.functional.pad(dd, (0, k - kk), value=math.inf)
        col = torch.nn.functional.pad(col, (0, k - kk))
    return dd, col


def _chunk(queries: torch.Tensor, chunk: Optional[int]) -> int:
    """Queries per distance block: ``chunk``, else 1024 on a card and 256 on
    the CPU, where a block of a few MB stays in cache (twice as fast at
    14,000 targets as 1024 queries). Blocks do not change results."""
    return chunk if chunk is not None else (1024 if queries.is_cuda else 256)


def knn(
    target: torch.Tensor,
    tmask: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact k-NN: ``(idx [Q, k] int32, sqdist [Q, k], valid [Q, k])``,
    ascending by distance."""
    chunk = _chunk(queries, chunk)
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
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact radius search with a fixed result cap: ``(idx [Q, cap],
    sqdist [Q, cap], valid [Q, cap], count [Q])``, the ``cap`` nearest within
    ``r`` ascending; ``count`` is the true number within ``r`` and may exceed
    ``cap``."""
    r2 = float(np.float32(r) ** 2)
    chunk = _chunk(queries, chunk)
    parts = []
    for s in range(0, max(queries.shape[0], 1), chunk):
        d = _chunk_sqdist(queries[s:s + chunk], target, tmask)
        inside = d <= r2
        dd, idx = smallest_k(torch.where(inside, d, math.inf), cap)
        parts.append((idx.to(torch.int32), dd, torch.sum(inside, dim=1, dtype=torch.int32)))
    idx, dd, count = (torch.cat(p) for p in zip(*parts))
    return idx, dd, torch.isfinite(dd), count
