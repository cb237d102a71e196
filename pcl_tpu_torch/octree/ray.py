"""Octree ray traversal and approximate nearest neighbour.

Counterpart of ``pcl_tpu/octree/ray.py``:

- ``ray_intersected_voxels`` (reference getIntersectedVoxelCenters): each
  ray sampled at half-leaf steps inside the tree's box, the distinct
  occupied voxels kept, batched over all rays;
- ``approx_nearest_search`` (reference approxNearestSearch): the nearest of
  16 points about the query's key in sorted order, its squared distances
  formed as the JAX package's compiled CPU code forms them (``sq_norm3``).

Both cast a cell as the JAX package does, with ``astype(int32)``: they
truncate toward zero, where ``linear.build`` floors (ROADMAP C73). The cast
is XLA's (``core.casts.xla_int32``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pcl_tpu_torch.core.casts import sq_norm3, xla_int32
from pcl_tpu_torch.octree.linear import LinearOctree, _find, morton_encode


def _truncated_cell(cell_f: torch.Tensor, side: int) -> torch.Tensor:
    return torch.clamp(xla_int32(cell_f), 0, side)


def ray_intersected_voxels(
    tree: LinearOctree,
    origin: torch.Tensor,       # [R, 3]
    direction: torch.Tensor,    # [R, 3] (normalized)
    max_range: float,
    max_steps: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[R, max_steps]`` morton keys of the occupied voxels along each ray
    (consecutive repeats dropped; -1 = none) and ``[R, max_steps]`` bool.
    Samples past ``max_range`` stay at ``max_range``."""
    res = tree.resolution
    dev = origin.device
    t = (torch.arange(max_steps, dtype=torch.float32, device=dev) + 0.5) * (res * 0.5)
    t = torch.clamp(t, max=max_range)
    pts = origin[:, None, :] + direction[:, None, :] * t[None, :, None]     # [R, S, 3]
    side = (1 << tree.depth) - 1
    cell_f = (pts - tree.origin[None, None, :]) / res
    inside = torch.all((cell_f >= 0) & (cell_f <= side + 1), dim=-1)
    keys = morton_encode(_truncated_cell(cell_f, side))
    # steps outside the box were clipped onto a boundary cell: their keys
    # neither match occupancy nor shadow the dedupe of the first inside step
    keys = torch.where(inside, keys, -1)
    flat = keys.reshape(-1)
    pos = _find(tree.keys, flat)
    hit = ((tree.keys[pos] == flat) & tree.mask[pos]).reshape(keys.shape) & inside
    new = keys != torch.roll(keys, 1, dims=1)
    new[:, 0] = True
    valid = hit & new
    return torch.where(valid, keys, -1), valid


def approx_nearest_search(
    tree: LinearOctree,
    xyz_sorted: torch.Tensor,   # [N, 3] the cloud gathered into tree order
    queries: torch.Tensor,      # [Q, 3]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate 1-NN: the closest of the 16 points in sorted slots ``-4 ..
    11`` about the query's key (the leaf's members are contiguous). Returns
    ``(index into tree order [Q], sqdist [Q])``; the first slot wins a tie."""
    side = (1 << tree.depth) - 1
    keys = morton_encode(_truncated_cell((queries - tree.origin[None, :]) / tree.resolution,
                                         side))
    start = torch.searchsorted(tree.keys, keys)
    n = tree.keys.shape[0]
    offs = torch.arange(-4, 12, device=queries.device)
    cand = torch.clamp(start[:, None] + offs[None, :], 0, max(n - 1, 0))
    d2 = sq_norm3(xyz_sorted[cand] - queries[:, None, :])
    d2 = torch.where(tree.mask[cand], d2, math.inf)
    j = torch.argmin(d2, dim=1, keepdim=True)
    idx = torch.gather(cand, 1, j)[:, 0]
    best = torch.gather(d2, 1, j)[:, 0]
    return idx.to(torch.int32), best
