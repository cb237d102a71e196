"""Exact masked 1-NN: the CUDA kernel ``csrc/nn1.cu`` and its plain version.

Counterpart of ``pcl_tpu/ops/pallas_nn.py`` (the Pallas kernel
``_nn1_kernel``, called by ``nn1_pallas``). Contract, shared by both versions:

- the score of target ``j`` for query ``q`` is ``||t_j||^2 - 2 q.t_j``, and
  ``1e30`` for a masked target;
- the least score wins, and on equal scores the lowest index;
- ``d2 = ||q - t_idx||^2`` is recomputed exactly for the winner, and is
  ``+inf`` (index 0) where no target is valid.

:func:`nn1` is the wrapper: on CUDA tensors it launches the kernel (and
counts the launch under ``ops.nn1.launches`` in ``utils/trace.py``'s
recorder), on CPU tensors it runs :func:`nn1_plain`. Nothing falls back
from one to the other. The kernel searches the targets in slices, so that
few queries still fill the card;
:func:`nn1_plan` chooses how many, and the wrapper allocates the scratch
``[slices, Q]`` that the kernel's merge pass reads.

The plain version computes the score with the kernel's arithmetic: three
fused multiply-adds in the kernel's order, each emulated in float64 (the
product of two float32 values is exact there) and rounded to float32. The two
therefore agree bit for bit, apart from double-rounding cases (about one in
2^29 operations).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from pcl_tpu_torch.ops import _build
from pcl_tpu_torch.utils import trace

_BIG = 1e30
# nn1_plain's score matrix holds at most this many entries per chunk
_CHUNK_ELEMS = 1 << 25


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)``: one rounding of the exact ``a*b + c``."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    """``((v0*v0 + v1*v1) + v2*v2)`` in float32, in the kernel's order."""
    out = v[:, 0] * v[:, 0]
    for k in range(1, v.shape[1]):
        out = out + v[:, k] * v[:, k]
    return out


def nn1_plain(
    target: torch.Tensor,
    tmask: torch.Tensor,
    queries: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, chunked over queries so that a
    chunk's score matrix holds at most ``_CHUNK_ELEMS`` entries. Any D."""
    nq, d = queries.shape
    m = target.shape[0]
    dev = queries.device
    idx = torch.zeros(nq, dtype=torch.int32, device=dev)
    if m == 0 or nq == 0:
        return idx, torch.full((nq,), float("inf"), device=dev)
    valid = tmask.to(torch.bool)
    tz = torch.where(valid[:, None], target, 0.0)
    w = torch.where(valid, _sq_norm(tz), _BIG)
    qn = -2.0 * queries
    step = max(1, _CHUNK_ELEMS // m)
    for s in range(0, nq, step):
        qc = qn[s:s + step]
        score = w[None, :]
        for k in range(d):
            score = _fma32(qc[:, k:k + 1], tz[None, :, k], score)
        idx[s:s + step] = torch.argmin(score, dim=1).to(torch.int32)
    d2 = _sq_norm(queries - target[idx.long()])
    d2 = torch.where(valid[idx.long()], d2, float("inf"))
    return idx, d2


# The kernel's blocking, as csrc/nn1.cu sets it: queries per block, targets
# per sub-tile. The wrapper only plans with them; the kernel takes any plan.
QUERY_BLOCK = 1024
SUB_TILE = 32
# a target slice is at least this long, and there are at most this many
MIN_SLICE = 256
MAX_SLICES = 256


def _slice_len(m: int, slices: int) -> int:
    """``ceil(m / slices)`` rounded up to whole sub-tiles."""
    return -(-(-(-m // slices)) // SUB_TILE) * SUB_TILE


@functools.lru_cache(maxsize=256)
def nn1_plan(nq: int, m: int, slots: int) -> Tuple[int, int]:
    """How the kernel cuts ``m`` targets for ``nq`` queries on a card that
    holds ``slots`` blocks at once: ``(slices, slice_len)``.

    The grid is ``ceil(nq / QUERY_BLOCK) x slices`` blocks of equal work, run
    in waves of ``slots``. A wave that is not full leaves SMs idle, so the
    share of full waves is the efficiency of a plan; the fewest slices within
    3% of the best efficiency win (each slice costs scratch ``[nq]`` and a
    pass of the merge). ``slice_len`` is a multiple of ``SUB_TILE``, and
    ``slices * slice_len >= m > (slices - 1) * slice_len``. No target: (0, 0).
    """
    if m <= 0 or nq <= 0:
        return 0, 0
    tiles = -(-nq // QUERY_BLOCK)
    plans = {}
    for s in range(1, max(1, min(MAX_SLICES, m // MIN_SLICE)) + 1):
        slice_len = _slice_len(m, s)
        slices = -(-m // slice_len)
        blocks = tiles * slices
        plans.setdefault(slices, (blocks / (-(-blocks // slots) * slots), slice_len))
    top = max(eff for eff, _ in plans.values())
    slices = min(s for s, (eff, _) in plans.items() if eff >= 0.97 * top)
    return slices, plans[slices][1]


def scratch_elems(nq: int, m: int, slices: int) -> int:
    """Float32 elements of the kernel's one scratch tensor: the packed
    targets ``[m, 4]``, then the slices' minima ``[slices, nq]`` f32 and
    indices ``[slices, nq]`` i32."""
    return 4 * m + 2 * slices * nq


_argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library, its argument types set: resolved once."""
    lib = _build.load("nn1")
    lib.pcl_nn1.argtypes = _argtypes
    lib.pcl_nn1.restype = ctypes.c_int
    if lib.pcl_nn1_query_block() != QUERY_BLOCK:
        raise RuntimeError("csrc/nn1.cu and ops/nn1.py disagree on the query block")
    return lib


@functools.lru_cache(maxsize=None)
def device_slots(index: int) -> int:
    """Blocks of the search kernel that CUDA device ``index`` holds at once
    (SMs x resident blocks per SM), asked of the CUDA runtime once."""
    with torch.cuda.device(index):
        slots = _lib().pcl_nn1_slots()
    if slots <= 0:
        raise RuntimeError("nn1: the CUDA runtime gave no occupancy for the kernel")
    return slots


def _check(target: torch.Tensor, tmask: torch.Tensor, queries: torch.Tensor) -> None:
    dev = queries.device
    if target.device != dev or tmask.device != dev:
        raise ValueError(f"nn1: tensors on different devices "
                         f"({target.device}, {tmask.device}, {dev})")
    if target.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError(f"nn1 kernel takes float32 points, got "
                        f"{target.dtype} and {queries.dtype}")
    if tmask.dtype != torch.bool:
        raise TypeError(f"nn1 kernel takes a bool mask, got {tmask.dtype}")
    if target.ndim != 2 or queries.ndim != 2 or target.shape[1] != 3 \
            or queries.shape[1] != 3:
        raise ValueError(f"nn1 kernel is 3-D only: target {tuple(target.shape)}, "
                         f"queries {tuple(queries.shape)}")
    if tmask.shape != (target.shape[0],):
        raise ValueError(f"nn1: mask {tuple(tmask.shape)} does not match "
                         f"target {tuple(target.shape)}")
    if not (target.is_contiguous() and tmask.is_contiguous()
            and queries.is_contiguous()):
        raise ValueError("nn1 kernel takes contiguous tensors")
    if 3 * max(target.shape[0], queries.shape[0]) >= 2 ** 31:
        raise ValueError("nn1 kernel indexes with int32: too many points")


def nn1(
    target: torch.Tensor, tmask: torch.Tensor, queries: torch.Tensor,
    slices: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked 1-NN: ``(index [Q] int32, sqdist [Q] f32)``.

    CUDA tensors: the kernel (3-D float32 only; anything else raises), with
    the targets cut into ``slices`` slices (default: :func:`nn1_plan`'s
    choice for this card; the result does not depend on it).
    CPU tensors: :func:`nn1_plain`."""
    if queries.device.type == "cpu":
        if target.device.type != "cpu" or tmask.device.type != "cpu":
            raise ValueError("nn1: tensors on different devices")
        return nn1_plain(target, tmask, queries)
    if queries.device.type != "cuda":
        raise ValueError(f"nn1: unsupported device {queries.device}")
    _check(target, tmask, queries)
    nq, m = queries.shape[0], target.shape[0]
    dev = queries.device
    lib = _lib()
    with _build.on_device(dev):
        if slices is None or m == 0:
            slices, slice_len = nn1_plan(nq, m, device_slots(dev.index))
        else:
            if not 1 <= slices <= MAX_SLICES:
                raise ValueError(f"nn1: slices must lie in [1, {MAX_SLICES}], got {slices}")
            slice_len = _slice_len(m, slices)
        if slices * nq >= 2 ** 31:
            raise ValueError("nn1 kernel indexes its scratch with int32: too many queries")
        out = torch.empty((2, nq), dtype=torch.int32, device=dev)
        scratch = torch.empty(scratch_elems(nq, m, slices), dtype=torch.float32, device=dev)
        idx, d2 = out[0], out[1].view(torch.float32)
        packed = scratch.data_ptr()
        sbest = packed + 16 * m
        err = lib.pcl_nn1(queries.data_ptr(), target.data_ptr(), tmask.data_ptr(), nq, m,
                          slices, slice_len, packed, sbest, sbest + 4 * slices * nq,
                          idx.data_ptr(), d2.data_ptr(), _build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: cudaError {err}")
    trace.count("ops.nn1.launches")
    return idx, d2
