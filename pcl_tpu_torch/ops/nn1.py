"""Exact masked 1-NN: the CUDA kernel ``csrc/nn1.cu`` and its plain version.

Counterpart of ``pcl_tpu/ops/pallas_nn.py`` (the Pallas kernel
``_nn1_kernel``, called by ``nn1_pallas``). Contract, shared by both versions:

- the score of target ``j`` for query ``q`` is ``||t_j||^2 - 2 q.t_j``, and
  ``1e30`` for a masked target;
- the least score wins, and on equal scores the lowest index;
- ``d2 = ||q - t_idx||^2`` is recomputed exactly for the winner, and is
  ``+inf`` (index 0) where no target is valid.

:func:`nn1` is the wrapper: on CUDA tensors it launches the kernel (and
counts the launch in ``nn1.launches``), on CPU tensors it runs
:func:`nn1_plain`. Nothing falls back from one to the other.

The plain version computes the score with the kernel's arithmetic: three
fused multiply-adds in the kernel's order, each emulated in float64 (the
product of two float32 values is exact there) and rounded to float32. The two
therefore agree bit for bit, apart from double-rounding cases (about one in
2^29 operations).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pcl_tpu_torch.ops import _build

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


_argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4


def _lib() -> ctypes.CDLL:
    lib = _build.load("nn1")
    lib.pcl_nn1.argtypes = _argtypes
    lib.pcl_nn1.restype = ctypes.c_int
    return lib


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
    target: torch.Tensor, tmask: torch.Tensor, queries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked 1-NN: ``(index [Q] int32, sqdist [Q] f32)``.

    CUDA tensors: the kernel (3-D float32 only; anything else raises).
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
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    d2 = torch.empty(nq, dtype=torch.float32, device=dev)
    packed = torch.empty((m, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().pcl_nn1(queries.data_ptr(), target.data_ptr(), tmask.data_ptr(),
                             nq, m, packed.data_ptr(), idx.data_ptr(),
                             d2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: cudaError {err}")
    nn1.launches += 1
    return idx, d2


nn1.launches = 0
