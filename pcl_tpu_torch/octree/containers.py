"""Octree leaf-container variants: the adjacency graph and the occupancy grid.

Counterpart of ``pcl_tpu/octree/containers.py``:

- ``adjacency`` (reference OctreePointCloudAdjacency): the sorted unique
  leaf keys and a ``[L, 26]`` table of neighbouring leaves, one
  ``searchsorted`` per direction;
- ``OccupancyGrid`` (reference OctreePointCloudOccupancy): a sorted key set
  with membership queries and inserts by merge and unique; an insert grows
  the key array by its batch, as in the JAX package.

Compaction takes one stable ``argsort`` of the negated flags, so kept keys
keep their order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pcl_tpu_torch.octree.linear import (
    PAD_KEY, LinearOctree, _find, _first_of_run, cell_of, morton_decode, morton_encode,
)

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if (dx, dy, dz) != (0, 0, 0)]


def _compact_keys(keys: torch.Tensor, keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept keys moved to the front in order, the rest ``PAD_KEY``."""
    n_kept = torch.sum(keep.to(torch.int32))
    order = torch.argsort(~keep, stable=True)
    lane = torch.arange(keys.shape[0], device=keys.device)
    return torch.where(lane < n_kept, keys[order], PAD_KEY), n_kept


def leaf_keys(tree: LinearOctree) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique leaf keys (``[N]`` padded with ``PAD_KEY``) and the
    number of leaves."""
    return _compact_keys(tree.keys, _first_of_run(tree.keys) & tree.mask)


def adjacency(tree: LinearOctree) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """26-neighbourhood leaf adjacency: ``(keys [L], nbr [L, 26] int32 leaf
    indices, -1 where the neighbour voxel is empty or outside, n_leaves)``
    (reference octree_pointcloud_adjacency.h computeNeighbors)."""
    keys, n_leaves = leaf_keys(tree)
    L = keys.shape[0]
    dev = keys.device
    cells = morton_decode(keys)                                     # [L, 3]
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)    # [26, 3]
    side = 1 << tree.depth
    ncells = cells[:, None, :] + offs[None, :, :]                   # [L, 26, 3]
    inb = torch.all((ncells >= 0) & (ncells < side), dim=-1)
    nkeys = morton_encode(torch.clamp(ncells, 0, side - 1))
    pos = _find(keys, nkeys.reshape(-1)).reshape(L, 26)
    hit = (keys[pos] == nkeys) & inb & (nkeys != PAD_KEY)
    valid_row = (torch.arange(L, device=dev) < n_leaves)[:, None]
    nbr = torch.where(hit & valid_row, pos, -1)
    return keys, nbr.to(torch.int32), n_leaves


class OccupancyGrid(NamedTuple):
    """Sorted unique occupied-voxel key set (padded with ``PAD_KEY``)."""
    keys: torch.Tensor          # [cap] int32 sorted, padding last
    n_occupied: torch.Tensor    # int32
    origin: torch.Tensor        # [3]
    resolution: torch.Tensor    # scalar
    depth: int


def occupancy_from_tree(tree: LinearOctree) -> OccupancyGrid:
    keys, n = leaf_keys(tree)
    return OccupancyGrid(keys=keys, n_occupied=n, origin=tree.origin,
                         resolution=tree.resolution, depth=tree.depth)


def is_occupied(grid: OccupancyGrid, pts: torch.Tensor) -> torch.Tensor:
    """Membership query (reference isVoxelOccupiedAtPoint)."""
    q = morton_encode(cell_of(pts, grid.origin, grid.resolution, grid.depth))
    pos = _find(grid.keys, q)
    return grid.keys[pos] == q


def set_occupied(grid: OccupancyGrid, pts: torch.Tensor, mask: torch.Tensor) -> OccupancyGrid:
    """Union the voxels of the valid points into the set (reference
    setOccupiedVoxelsAtPointsFromCloud); the key array grows by
    ``len(pts)``."""
    new = morton_encode(cell_of(pts, grid.origin, grid.resolution, grid.depth))
    new = torch.where(mask, new, PAD_KEY)
    merged = torch.sort(torch.cat([grid.keys, new])).values
    uniq = _first_of_run(merged) & (merged != PAD_KEY)
    keys, n = _compact_keys(merged, uniq)
    return grid._replace(keys=keys, n_occupied=n)
