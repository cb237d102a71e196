"""Double-buffered octree: change detection and differential encoding.

Counterpart of ``pcl_tpu/octree/double_buffer.py`` (reference Octree2BufBase
and OctreePointCloudChangeDetector). A buffer is a ``LinearOctree``; new and
removed leaves are sorted-set differences on the device, read back once a
call. The origin is pinned at the first buffer, so that every buffer keys
the same grid (ROADMAP C72). The XOR-differential occupancy bitmaps are
numpy (``packbits``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.octree.linear import PAD_KEY, LinearOctree, _find, _first_of_run, build


def _unique_keys(tree: LinearOctree) -> torch.Tensor:
    """Sorted leaf keys, duplicates replaced by trailing ``PAD_KEY``."""
    keep = _first_of_run(tree.keys) & tree.mask
    return torch.sort(torch.where(keep, tree.keys, PAD_KEY)).values


def _member_of(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """``queries`` in ``sorted_keys`` (padding never matches)."""
    pos = _find(sorted_keys, queries)
    return (sorted_keys[pos] == queries) & (queries != PAD_KEY)


def _only_in(a: Optional[LinearOctree], b: Optional[LinearOctree]) -> Optional[torch.Tensor]:
    """Unique leaf keys of ``a`` not in ``b``, ascending, on the device."""
    if a is None:
        return None
    au = _unique_keys(a)
    sel = au != PAD_KEY
    if b is not None:
        sel = sel & ~_member_of(_unique_keys(b), au)
    return au[sel]


@dataclasses.dataclass
class DoubleBufferedOctree:
    """Two-buffer octree over successive frames of one stream:

        dbo = DoubleBufferedOctree(resolution=0.05)
        dbo.set_cloud(xyz0, mask0)      # buffer A
        dbo.switch_buffers()            # A -> previous, B current
        dbo.set_cloud(xyz1, mask1)      # buffer B
        new = dbo.new_leaf_keys()       # leaves only in the current buffer

    Clouds given as tensors stay on their device; numpy arrays go to
    ``device`` (default CUDA)."""

    resolution: float
    depth: int = 10
    origin: Optional[np.ndarray] = None
    device: Optional[str] = None
    _bufs: Tuple[Optional[LinearOctree], Optional[LinearOctree]] = (None, None)
    _current: int = 0

    def set_cloud(self, xyz, mask) -> None:
        dev = xyz.device if isinstance(xyz, torch.Tensor) else _device(self.device)
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)
        origin = None if self.origin is None else torch.as_tensor(
            np.asarray(self.origin, np.float32), device=dev)
        tree = build(xyz, mask, self.resolution, origin=origin, depth=self.depth)
        if self.origin is None:
            # pin the shared grid frame at the first buffer
            self.origin = tree.origin.cpu().numpy()
        bufs = list(self._bufs)
        bufs[self._current] = tree
        self._bufs = tuple(bufs)

    def switch_buffers(self) -> None:
        """Flip current and previous (reference switchBuffers)."""
        self._current = 1 - self._current

    @property
    def current(self) -> Optional[LinearOctree]:
        return self._bufs[self._current]

    @property
    def previous(self) -> Optional[LinearOctree]:
        return self._bufs[1 - self._current]

    def new_leaf_keys(self) -> np.ndarray:
        """Morton keys of leaves occupied in the current buffer only
        (reference serializeNewLeafs)."""
        keys = _only_in(self.current, self.previous)
        return np.zeros((0,), np.int32) if keys is None else keys.cpu().numpy()

    def removed_leaf_keys(self) -> np.ndarray:
        """Leaves occupied in the previous buffer only."""
        keys = _only_in(self.previous, self.current)
        return np.zeros((0,), np.int32) if keys is None else keys.cpu().numpy()

    def new_point_indices(self) -> np.ndarray:
        """Original-cloud indices of the current buffer's points in new
        voxels, in tree order (the OctreePointCloudChangeDetector result)."""
        cur = self.current
        new_keys = _only_in(cur, self.previous)
        if new_keys is None or new_keys.shape[0] == 0:
            return np.zeros((0,), np.int32)
        hit = _member_of(new_keys, cur.keys) & cur.mask
        return cur.order[hit].cpu().numpy()

    # -- differential (XOR) occupancy serialization -----------------------

    def occupancy_bitmap(self, which: str = "current") -> np.ndarray:
        """Dense leaf-occupancy bitmap ``[2^(3 d) / 8]`` uint8 at the
        serialization depth ``d = min(depth, 7)``, packed."""
        tree = self.current if which == "current" else self.previous
        d = min(self.depth, 7)
        out = np.zeros(1 << (3 * d), np.uint8)
        if tree is not None:
            keys = _unique_keys(tree).cpu().numpy()
            keys = keys[keys != PAD_KEY]
            out[np.unique(keys >> (3 * (self.depth - d)))] = 1
        return np.packbits(out)

    def xor_serialize(self) -> np.ndarray:
        """Differential occupancy stream: current XOR previous (reference
        Octree2BufBase::serializeTree with doXOREncoding)."""
        return self.occupancy_bitmap("current") ^ self.occupancy_bitmap("previous")

    @staticmethod
    def xor_apply(prev_bitmap: np.ndarray, diff: np.ndarray) -> np.ndarray:
        """Reconstruct the current occupancy from previous + diff."""
        return prev_bitmap ^ diff
