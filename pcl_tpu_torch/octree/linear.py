"""Linear morton-order octree.

Counterpart of ``pcl_tpu/octree/linear.py``. Key layout: depth d <= 10;
per-axis cell indices in ``[0, 2^d)``; key = interleave(x, y, z), 3d bits in
an int32. Keys of valid points sort ascending; padding sorts to the end
(key ``2^31 - 1``).

- ``build``: one stable sort of the keys, so that the points of one leaf
  keep their cloud order (``voxel_search``'s output order; ROADMAP C8);
- ``leaf_centroids``: rows already sorted by leaf, summed by kernel B2
  (``ops.segsum.segment_sum_sorted``) on the card, its plain version on the
  CPU;
- a cell index is ``floor((p - origin) / res)`` cast as XLA casts it
  (``core.casts.xla_int32``: NaN to 0, saturated) before the clip, so a
  point beyond the int32 range lands on the top cell, as in the JAX package
  (ROADMAP C71).

ICP's cell backend also sorts its source by ``morton_encode``'s keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.ops import segsum

PAD_KEY = 2 ** 31 - 1


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` to every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def _compact3(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x9249249
    v = (v | (v >> 2)) & 0x30C30C3
    v = (v | (v >> 4)) & 0x300F00F
    v = (v | (v >> 8)) & 0x30000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def morton_encode(cell: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` integer cell coords -> ``[...]`` int32 morton keys."""
    cell = cell.to(torch.int32)
    return (_spread3(cell[..., 0])
            | (_spread3(cell[..., 1]) << 1)
            | (_spread3(cell[..., 2]) << 2))


def morton_decode(key: torch.Tensor) -> torch.Tensor:
    """``[...]`` int32 keys -> ``[..., 3]`` int32 cell coords."""
    key = key.to(torch.int32)
    return torch.stack([_compact3(key), _compact3(key >> 1), _compact3(key >> 2)], dim=-1)


def _first_of_run(keys: torch.Tensor) -> torch.Tensor:
    """True where a key differs from the one before it (and at row 0)."""
    first = keys != torch.roll(keys, 1)
    if first.numel():
        first[0] = True
    return first


@dataclasses.dataclass(frozen=True)
class LinearOctree:
    origin: torch.Tensor        # [3] f32 lower corner
    resolution: torch.Tensor    # scalar f32 leaf size
    depth: int                  # <= 10
    keys: torch.Tensor          # [N] int32 morton keys, sorted (padding last)
    order: torch.Tensor         # [N] int32 permutation into the original cloud
    mask: torch.Tensor          # [N] bool validity in sorted order

    @property
    def leaf_count(self) -> torch.Tensor:
        return torch.sum((_first_of_run(self.keys) & self.mask).to(torch.int32))


def cell_of(pts: torch.Tensor, origin: torch.Tensor, resolution: torch.Tensor,
            depth: int) -> torch.Tensor:
    """``clip(floor((pts - origin) / res).astype(int32), 0, 2^depth - 1)``
    with XLA's cast."""
    cell = xla_int32(torch.floor((pts - origin) / resolution))
    return torch.clamp(cell, 0, (1 << depth) - 1)


def build(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    resolution,
    origin: Optional[torch.Tensor] = None,
    depth: int = 10,
) -> LinearOctree:
    """Sort points into morton order at leaf resolution. With ``origin``
    None the tree's corner is the valid points' minimum: two trees compared
    by key (``change_detection``) need one shared origin."""
    dev = xyz.device
    resolution = torch.as_tensor(resolution, dtype=torch.float32, device=dev)
    if origin is None:
        origin = torch.amin(torch.where(mask[:, None], xyz, math.inf), dim=0) \
            if xyz.shape[0] else torch.full((3,), math.inf, device=dev)
        origin = torch.where(torch.isfinite(origin), origin, 0.0)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    keys = morton_encode(cell_of(xyz, origin, resolution, depth))
    keys = torch.where(mask, keys, PAD_KEY)
    order = torch.argsort(keys, stable=True)
    return LinearOctree(origin=origin, resolution=resolution, depth=depth,
                        keys=keys[order], order=order.to(torch.int32), mask=mask[order])


def _key_of_points(tree: LinearOctree, pts: torch.Tensor) -> torch.Tensor:
    return morton_encode(cell_of(pts, tree.origin, tree.resolution, tree.depth))


def _find(sorted_keys: torch.Tensor, q: torch.Tensor, right: bool = False) -> torch.Tensor:
    """``searchsorted`` clipped to a valid row."""
    pos = torch.searchsorted(sorted_keys, q.contiguous(), right=right)
    return torch.clamp(pos, 0, max(sorted_keys.shape[0] - 1, 0))


def is_voxel_occupied(tree: LinearOctree, pts: torch.Tensor) -> torch.Tensor:
    """``[Q, 3]`` -> ``[Q]`` bool: does the leaf voxel of each point hold any
    cloud point (reference isVoxelOccupiedAtPoint)."""
    q = _key_of_points(tree, pts)
    pos = _find(tree.keys, q)
    return (tree.keys[pos] == q) & tree.mask[pos]


def voxel_search(tree: LinearOctree, pts: torch.Tensor,
                 cap: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of all cloud points in each query's leaf voxel (reference
    OctreePointCloudSearch::voxelSearch): ``(idx [Q, cap] int32, valid [Q,
    cap])``, in the cloud's order within a leaf."""
    q = _key_of_points(tree, pts)
    lo = torch.searchsorted(tree.keys, q)
    hi = torch.searchsorted(tree.keys, q, right=True)
    pos = lo[:, None] + torch.arange(cap, device=q.device)[None, :]
    valid = pos < hi[:, None]
    pos = torch.clamp(pos, 0, max(tree.keys.shape[0] - 1, 0))
    return tree.order[pos], valid & tree.mask[pos]


def leaf_centroids(tree: LinearOctree, xyz: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-leaf centroids and counts, compacted to the front (reference
    OctreePointCloudVoxelCentroid). ``xyz`` is the cloud the tree was built
    from, in its own order. Returns ``(centroids [N, 3], counts [N],
    n_leaves)``. The sums are one call of kernel B2 on ``[N, 4]`` rows (xyz
    and a count column), whose ids ascend: padding takes id ``N - 1``, after
    every leaf."""
    n = tree.keys.shape[0]
    first = _first_of_run(tree.keys) & tree.mask
    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    seg = torch.where(tree.mask, seg, n - 1).to(torch.int32)
    w = tree.mask.to(torch.float32)
    vals = torch.cat([xyz[tree.order.long()] * w[:, None], w[:, None]], dim=1).contiguous()
    sums = segsum.segment_sum_sorted(vals, seg.contiguous())
    cnt = sums[:, 3]
    n_leaves = torch.sum(first.to(torch.int32))
    valid = torch.arange(n, device=xyz.device) < n_leaves
    centroids = torch.where(valid[:, None],
                            sums[:, :3] / torch.clamp(cnt, min=1.0)[:, None], 0.0)
    return centroids, torch.where(valid, cnt, 0.0), n_leaves


def change_detection(tree_now: LinearOctree, tree_before: LinearOctree) -> torch.Tensor:
    """Mask over the original cloud order of ``tree_now`` of points whose
    leaf voxel is not occupied in ``tree_before`` (reference
    OctreePointCloudChangeDetector). Both trees need one origin."""
    pos = _find(tree_before.keys, tree_now.keys)
    present = (tree_before.keys[pos] == tree_now.keys) & tree_before.mask[pos]
    new_sorted = tree_now.mask & ~present
    out = torch.zeros(tree_now.keys.shape[0], dtype=torch.bool, device=new_sorted.device)
    out[tree_now.order.long()] = new_sorted
    return out


def box_search(tree: LinearOctree, box_min: torch.Tensor, box_max: torch.Tensor,
               xyz: torch.Tensor, cap: int = 1024
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All points inside an axis-aligned box (reference
    OctreePointCloudSearch::boxSearch), the first ``cap`` in tree order:
    ``(idx [cap], valid [cap], count)``."""
    dev = xyz.device
    box_min = torch.as_tensor(box_min, dtype=torch.float32, device=dev)
    box_max = torch.as_tensor(box_max, dtype=torch.float32, device=dev)
    p = xyz[tree.order.long()]
    inside = tree.mask & torch.all((p >= box_min) & (p <= box_max), dim=-1)
    count = torch.sum(inside.to(torch.int32))
    rank = torch.cumsum(inside.to(torch.int64), 0) - 1
    slot = torch.where(inside & (rank < cap), rank, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    idx[slot] = tree.order          # rows past the cap all land in the dropped slot
    valid = torch.arange(cap, device=dev) < torch.clamp(count, max=cap)
    return idx[:cap], valid, count


def at_depth(tree: LinearOctree, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occupied node keys at a shallower level (fixed-depth iterator):
    ``(keys [N] int32 shifted to the level, first [N] marking each occupied
    node once, in sorted order)``."""
    if not (0 <= level <= tree.depth):
        raise ValueError("level out of range")
    shift = 3 * (tree.depth - level)
    k = torch.where(tree.mask, tree.keys >> shift, PAD_KEY)
    return k, _first_of_run(k) & tree.mask
