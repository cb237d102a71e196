"""Segmented sums over sorted segment ids: the CUDA kernel ``csrc/segsum.cu``,
its plain version, and the voxel-sum wrappers built on them.

Counterpart of ``pcl_tpu/ops/pallas_segsum.py`` (the Pallas kernel
``_segsum_kernel``, called by ``segment_sum_sorted``; wrappers
``voxel_sums_pallas``, ``voxel_centroids_pallas`` and ``dense_cell_ids``).
Contract, shared by both versions of :func:`segment_sum_sorted`:

- ``vals [N, W]`` float32 and ``seg [N]`` int32 ids that never decrease: the
  valid rows step by 0 or 1 from id 0, and the invalid tail carries one larger
  id (``N`` or ``2**28``, say);
- output row ``s`` of ``[N, W]`` is the sum of the rows with ``seg == s``;
  rows whose id lies outside ``[0, N)`` are dropped, and a row with no member
  is 0 (the JAX kernel leaves those rows undefined; every caller masks);
- the rows of a segment are added in ascending row order, starting from 0,
  so the result is deterministic.

:func:`segment_sum_sorted` is the wrapper: on CUDA tensors it launches the
kernel (and counts the launch in ``segment_sum_sorted.launches``), on CPU
tensors it runs :func:`segment_sum_sorted_plain`. Nothing falls back from one
to the other. The kernel has no width limit (the TPU kernel's ``W <= 120``
was a lane limit).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pcl_tpu_torch.ops import _build

I32_BIG = 2 ** 31 - 1


def segment_sum_sorted_plain(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, adding each segment's rows onto zeros in
    ascending row order, deterministically: ``index_add_`` on the CPU (a
    sequential loop over the rows) and ``index_put_`` with ``accumulate`` on
    the card (a stable sort of the ids, then each run of equal ids added in
    order; the card's ``index_add_`` uses atomics). Ids outside ``[0, N)`` go
    to a spare row that is dropped."""
    n, w = vals.shape
    keep = (seg >= 0) & (seg < n)
    idx = torch.where(keep, seg.long(), n)
    out = torch.zeros((n + 1, w), dtype=vals.dtype, device=vals.device)
    if vals.device.type == "cpu":
        out.index_add_(0, idx, vals)
    else:
        out.index_put_((idx,), vals, accumulate=True)
    return out[:n]


_argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3


def _lib() -> ctypes.CDLL:
    lib = _build.load("segsum")
    lib.pcl_segsum.argtypes = _argtypes
    lib.pcl_segsum.restype = ctypes.c_int
    return lib


def _check(vals: torch.Tensor, seg: torch.Tensor) -> None:
    if seg.device != vals.device:
        raise ValueError(f"segment_sum_sorted: tensors on different devices "
                         f"({vals.device}, {seg.device})")
    if vals.dtype != torch.float32 or seg.dtype != torch.int32:
        raise TypeError(f"segsum kernel takes float32 values and int32 ids, got "
                        f"{vals.dtype} and {seg.dtype}")
    if vals.ndim != 2 or seg.shape != (vals.shape[0],):
        raise ValueError(f"segsum kernel takes vals [N, W] and seg [N], got "
                         f"{tuple(vals.shape)} and {tuple(seg.shape)}")
    if not (vals.is_contiguous() and seg.is_contiguous()):
        raise ValueError("segsum kernel takes contiguous tensors")
    if vals.shape[0] >= 2 ** 31 - 1:
        raise ValueError("segsum kernel indexes rows with int32: too many rows")


def segment_sum_sorted(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Segment sums ``[N, W]`` of ``vals`` over non-decreasing ids ``seg``.

    CUDA tensors: the kernel (float32 values, int32 ids; anything else
    raises). CPU tensors: :func:`segment_sum_sorted_plain`."""
    if vals.device.type == "cpu":
        if seg.device.type != "cpu":
            raise ValueError("segment_sum_sorted: tensors on different devices")
        return segment_sum_sorted_plain(vals, seg)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted: unsupported device {vals.device}")
    _check(vals, seg)
    n, w = vals.shape
    dev = vals.device
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    if n == 0 or w == 0:
        return out
    starts = torch.empty(n + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().pcl_segsum(vals.data_ptr(), seg.data_ptr(), n, w,
                                starts.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError {err}")
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0


def sort_segments(
    keys: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort of the rows by cell key, and the segments of equal keys:
    ``(order [N], seg_id [N] int32, first [N] bool)``.

    ``keys [N, K]`` int32 are compared lexicographically, the last column
    the most significant (one column for a dense cell id; x, y, z for the
    three-key sort). Invalid rows sort last. ``seg_id`` numbers the distinct
    keys among the sorted valid rows (invalid rows get ``N - 1``) and
    ``first`` flags each segment's first row. Equal keys keep their original
    order, which fixes the order of the additions within a segment."""
    n = keys.shape[0]
    keys = torch.where(mask[:, None], keys, I32_BIG)
    order = torch.argsort(keys[:, 0], stable=True)
    for c in range(1, keys.shape[1]):
        order = order[torch.argsort(keys[order, c], stable=True)]
    ks = keys[order]
    valid = mask[order]
    first = torch.ones_like(valid)
    first[1:] = torch.any(ks[1:] != ks[:-1], dim=1)
    first = first & valid
    seg_id = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    seg_id = torch.where(valid, seg_id, n - 1).to(torch.int32)
    return order, seg_id, first


def sorted_inputs(
    columns: torch.Tensor, mask: torch.Tensor, order: torch.Tensor, seg_id: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's inputs for a voxel sum from a :func:`sort_segments`
    sort: ``columns [N, W]`` (masked rows zeroed) and a weight column, in
    sorted order (``vals [N, W+1]``), and their segment ids; the invalid
    tail has zero rows and id ``N``."""
    n = columns.shape[0]
    w0 = mask.to(torch.float32)
    valid = mask[order]
    vals = torch.cat([columns * w0[:, None], w0[:, None]], dim=1)[order]
    vals = torch.where(valid[:, None], vals, 0.0).contiguous()
    return vals, torch.where(valid, seg_id, n).to(torch.int32)


def voxel_sums(
    columns: torch.Tensor, mask: torch.Tensor, lin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel segment sums of ``columns [N, W]`` keyed on dense cell ids
    ``lin``: ``(sums [N, W+1] compacted in cell order, the last column the
    point count; n_voxels as a 0-d int32 tensor)``."""
    order, seg_id, first = sort_segments(lin[:, None], mask)
    sums = segment_sum_sorted(*sorted_inputs(columns, mask, order, seg_id))
    return sums, torch.sum(first, dtype=torch.int32)


def cell_grid(xyz: torch.Tensor, mask: torch.Tensor, leaf_size):
    """Integer cell coordinates ``floor(xyz / leaf)`` (float32 division per
    axis, ``leaf_size`` scalar or ``[3]``) and the masked bounding box of the
    cells: ``(coords [N, 3] int32, cmin [3], span [3])``."""
    leaf = torch.broadcast_to(
        torch.as_tensor(leaf_size, dtype=torch.float32, device=xyz.device), (3,))
    coords = torch.floor(xyz / leaf).to(torch.int32)
    cmin = torch.amin(torch.where(mask[:, None], coords, I32_BIG), dim=0)
    cmax = torch.amax(torch.where(mask[:, None], coords, -I32_BIG), dim=0)
    return coords, cmin, torch.clamp(cmax - cmin + 1, min=1)


def linear_cell_ids(coords, cmin, span, mask) -> torch.Tensor:
    """Row-major dense id ``(z * sy + y) * sx + x`` relative to ``cmin``
    (``I32_BIG`` for invalid points): z-major, the (z, y, x) lexicographic
    order of the cells. The products wrap in int32 as the JAX package's do;
    callers use the ids only below 2^30 cells."""
    rel = torch.clamp(coords - cmin[None, :], min=0)
    lin = (rel[:, 2] * span[1] + rel[:, 1]) * span[0] + rel[:, 0]
    return torch.where(mask, lin, I32_BIG).to(torch.int32)


def dense_cell_ids(xyz: torch.Tensor, mask: torch.Tensor, leaf_size) -> torch.Tensor:
    """Row-major dense cell id over the masked bounding box (``I32_BIG`` for
    invalid points)."""
    return linear_cell_ids(*cell_grid(xyz, mask, leaf_size), mask)


def voxel_centroids(cloud, leaf_size):
    """Voxel centroids of a Cloud through :func:`voxel_sums`:
    ``(centroids [N, 3] compacted in cell order, mask [N])``, as
    ``voxel_downsample`` gives."""
    xyz, mask = cloud.xyz, cloud.mask
    n = xyz.shape[0]
    sums, n_voxels = voxel_sums(xyz, mask, dense_cell_ids(xyz, mask, leaf_size))
    out_mask = torch.arange(n, device=xyz.device) < n_voxels
    cents = sums[:, :3] / torch.clamp(sums[:, 3:4], min=1.0)
    return torch.where(out_mask[:, None], cents, 0.0), out_mask
