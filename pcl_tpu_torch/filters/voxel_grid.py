"""Voxel-grid downsampling: sort-based segment reduction.

Counterpart of ``pcl_tpu/filters/voxel_grid.py``. Points are sorted by cell
(one stable sort of the dense linear cell id over the masked bounding box, or
a three-key lexicographic sort when that box holds 2^30 cells or more), cell
boundaries give segment ids, and each voxel becomes the mean of its points.
The output keeps the input capacity, with the voxels compacted at the front
in (z, y, x) cell order and the rest masked padding.

The sums go through one segment sum (``ops/segsum.py``) for the coordinates
and every averaged attribute at once, in both bounding-box regimes, at any
capacity and attribute width: kernel B2 on CUDA tensors, its plain version on
CPU tensors. The stable sort adds each voxel's points in original point
order, as the JAX package's CPU scatter path does. Which bounding-box regime
applies is read back once (the JAX package's ``lax.cond``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.ops import segsum

# the dense id is used below this many bounding-box cells (int32-exact with
# ample margin for the float32 product that tests it)
_DENSE_CELLS = 2.0 ** 30


def _n_cells(span: torch.Tensor) -> torch.Tensor:
    """Bounding-box cell count as a float32 product (int32 would wrap)."""
    s = span.to(torch.float32)
    return s[0] * s[1] * s[2]


def _sorted_cell_segments(
    xyz: torch.Tensor, mask: torch.Tensor, leaf_size
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort points by voxel cell: ``(order [N], seg_id [N], first [N])``,
    where ``seg_id`` numbers the distinct cells among the sorted valid points
    (invalid points get ``N - 1``) and ``first`` flags each cell's first
    point. Equal cells keep their original order."""
    coords, cmin, span = segsum.cell_grid(xyz, mask, leaf_size)
    if bool(_n_cells(span) < _DENSE_CELLS):
        keys = segsum.linear_cell_ids(coords, cmin, span, mask)[:, None]
    else:
        keys = coords           # lexicographic (z, y, x): z most significant
    return segsum.sort_segments(keys, mask)


def voxel_downsample(cloud: Cloud, leaf_size, average_attrs: bool = True) -> Cloud:
    """Replace all points in each voxel by their centroid.

    ``leaf_size`` is a scalar or per-axis ``[3]``. Attributes are averaged
    per voxel when ``average_attrs`` (PCL's downsample_all_data), else
    dropped; integer attributes come back as float32 means. The coordinates
    and the flattened attributes ride one cell sort into one segment sum:
    kernel B2 on CUDA tensors, its plain version on CPU tensors."""
    n = cloud.capacity
    mask = cloud.mask
    attr_items = sorted(cloud.attrs.items()) if average_attrs else []
    order, seg_id, first = _sorted_cell_segments(cloud.xyz, mask, leaf_size)
    columns = torch.cat([cloud.xyz] + [v.reshape(n, -1).to(torch.float32)
                                       for _, v in attr_items], dim=1)
    sums = segsum.segment_sum_sorted(*segsum.sorted_inputs(columns, mask, order, seg_id))
    out_mask = torch.arange(n, device=mask.device) < torch.sum(first, dtype=torch.int32)
    means = torch.where(out_mask[:, None],
                        sums[:, :-1] / torch.clamp(sums[:, -1:], min=1.0), 0.0)
    attrs = {}
    off = 3
    for k, v in attr_items:
        width = math.prod(v.shape[1:])
        mean_dt = v.dtype if v.dtype.is_floating_point else torch.float32
        attrs[k] = means[:, off:off + width].reshape(v.shape).to(mean_dt)
        off += width
    return Cloud(xyz=means[:, :3], mask=out_mask, attrs=attrs, width=0, height=1)


def uniform_sample(cloud: Cloud, leaf_size) -> Cloud:
    """Keep, per voxel, the input point closest to the voxel centre (the
    first in cell-sorted order on a tie). The output points are input
    points, compacted at the front in cell order."""
    n = cloud.capacity
    dev = cloud.xyz.device
    leaf = torch.broadcast_to(
        torch.as_tensor(leaf_size, dtype=torch.float32, device=dev), (3,))
    order, seg_id, first = _sorted_cell_segments(cloud.xyz, cloud.mask, leaf)
    seg = seg_id.long()
    xyz_s = cloud.xyz[order]
    center = (torch.floor(xyz_s / leaf) + 0.5) * leaf
    sq = (xyz_s - center) ** 2
    d = torch.where(cloud.mask[order], (sq[:, 0] + sq[:, 1]) + sq[:, 2], math.inf)
    best = torch.full((n,), math.inf, device=dev).scatter_reduce(
        0, seg, d, reduce="amin", include_self=False)
    is_best = (d == best[seg]) & cloud.mask[order]
    pos = torch.arange(n, device=dev)
    first_best = torch.full((n,), n, device=dev).scatter_reduce(
        0, seg, torch.where(is_best, pos, n), reduce="amin", include_self=False)
    keep_sorted = pos == first_best[seg]
    rep = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, seg, torch.where(keep_sorted, order, 0))
    valid = pos < torch.sum(first.to(torch.int32))
    return cloud.take(rep, valid=valid)
