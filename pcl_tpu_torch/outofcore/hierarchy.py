"""Hierarchical disk-paged octree — the reference's octree_base layout.

Unlike the flat top-cell store (store.py), this mirrors the reference's
actual on-disk structure (reference: outofcore/include/pcl/outofcore/
octree_base.h:150, octree_base_node.h, octree_disk_container.h): one
DIRECTORY per node with a JSON metadata file (the ``.oct_idx`` analog) and
a point payload; nodes SPLIT into up to 8 child directories (named 0-7 by
octant) when they exceed ``points_per_node``; internal nodes carry
random-sampled LOD payloads (the reference's buildLOD) so depth-bounded
queries stream coarse data without touching the leaves.

Capabilities (reference parity):
- recursive insertion with node splitting (octree_base_node addDataToLeaf)
- per-node metadata: bounds, depth, point counts, children (oct_idx)
- breadth_first()/depth_first() iterators (outofcore depth-first/
  breadth-first iterators)
- query_bb_includes(bmin, bmax, depth) — depth-bounded box query serving
  LOD payloads at internal depths (queryBBIncludes w/ query_depth)
- get_occupied_voxel_centers(depth)
- build_lod() — subtree random-sample LOD construction

Counterpart of ``pcl_tpu/outofcore/hierarchy.py``: a copy of its numpy
code, the payloads written by the port's PCD writer. The tree works on host
rows; the clouds that queries return are placed on the tree's ``device``
(default CUDA).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, from_numpy, to_numpy
from pcl_tpu_torch.io import pcd

_META = "node.oct_idx.json"
_PAYLOAD = "points.pcd"
_LOD = "lod.pcd"
_HOST = "cpu"       # payloads are read and written through host clouds


def _read_meta(node_dir: str) -> dict:
    with open(os.path.join(node_dir, _META)) as f:
        return json.load(f)


def _write_meta(node_dir: str, meta: dict) -> None:
    with open(os.path.join(node_dir, _META), "w") as f:
        json.dump(meta, f)


def _read_payload(node_dir: str, name: str = _PAYLOAD) -> np.ndarray:
    path = os.path.join(node_dir, name)
    if not os.path.exists(path):
        return np.zeros((0, 3), np.float32)
    xyz, _ = to_numpy(pcd.load(path, device=_HOST), compact=True)
    return xyz


def _write_payload(node_dir: str, xyz: np.ndarray,
                   name: str = _PAYLOAD) -> None:
    pcd.save(os.path.join(node_dir, name), from_numpy(xyz, device=_HOST))


class HierarchicalOutofcoreOctree:
    """See module docstring. All coordinates float64 host-side (payloads
    stored f32 like the reference's PCD containers)."""

    def __init__(self, root: str, device=None):
        self.root = root
        self.device = device
        self.meta = _read_meta(root)

    # ------------------------------------------------------------ create
    @classmethod
    def create(cls, root: str, bb_min, bb_max, max_depth: int = 6,
               points_per_node: int = 4096, device=None) -> "HierarchicalOutofcoreOctree":
        os.makedirs(root, exist_ok=True)
        _write_meta(root, {
            "bb_min": list(map(float, bb_min)),
            "bb_max": list(map(float, bb_max)),
            "depth": 0,
            "max_depth": int(max_depth),
            "points_per_node": int(points_per_node),
            "point_count": 0,
            "subtree_count": 0,
            "children": [False] * 8,
        })
        return cls(root, device=device)

    # --------------------------------------------------------- insertion
    def add_points(self, xyz) -> int:
        """Insert points (array [N,3] or Cloud); returns points accepted
        (those inside the root bounds — the reference silently drops
        out-of-bounds points too)."""
        if isinstance(xyz, Cloud):
            xyz, _ = to_numpy(xyz, compact=True)
        xyz = np.asarray(xyz, np.float32)
        bb_min = np.asarray(self.meta["bb_min"])
        bb_max = np.asarray(self.meta["bb_max"])
        inside = ((xyz >= bb_min) & (xyz < bb_max)).all(axis=1)
        pts = xyz[inside]
        if len(pts):
            self._insert(self.root, pts)
        return int(inside.sum())

    def _insert(self, node_dir: str, pts: np.ndarray) -> None:
        meta = _read_meta(node_dir)
        meta["subtree_count"] += len(pts)
        is_leaf = not any(meta["children"])
        at_max = meta["depth"] >= self.meta["max_depth"]
        if is_leaf and (at_max
                        or meta["point_count"] + len(pts)
                        <= self.meta["points_per_node"]):
            cur = _read_payload(node_dir)
            _write_payload(node_dir, np.concatenate([cur, pts]))
            meta["point_count"] = len(cur) + len(pts)
            _write_meta(node_dir, meta)
            return
        if is_leaf:
            # split: redistribute the resident payload together with the
            # new points (octree_base_node subdividePoint)
            cur = _read_payload(node_dir)
            pts = np.concatenate([cur, pts])
            if os.path.exists(os.path.join(node_dir, _PAYLOAD)):
                os.remove(os.path.join(node_dir, _PAYLOAD))
            meta["point_count"] = 0
        bb_min = np.asarray(meta["bb_min"])
        bb_max = np.asarray(meta["bb_max"])
        mid = 0.5 * (bb_min + bb_max)
        octant = ((pts[:, 0] >= mid[0]).astype(np.int64)
                  | ((pts[:, 1] >= mid[1]).astype(np.int64) << 1)
                  | ((pts[:, 2] >= mid[2]).astype(np.int64) << 2))
        for o in range(8):
            sel = octant == o
            if not sel.any():
                continue
            child_dir = os.path.join(node_dir, str(o))
            if not meta["children"][o]:
                lo = np.where([o & 1, o & 2, o & 4], mid, bb_min)
                hi = np.where([o & 1, o & 2, o & 4], bb_max, mid)
                os.makedirs(child_dir, exist_ok=True)
                _write_meta(child_dir, {
                    "bb_min": lo.tolist(), "bb_max": hi.tolist(),
                    "depth": meta["depth"] + 1,
                    "point_count": 0, "subtree_count": 0,
                    "children": [False] * 8,
                })
                meta["children"][o] = True
            self._insert(child_dir, pts[sel])
        _write_meta(node_dir, meta)

    # --------------------------------------------------------- iterators
    def depth_first(self) -> Iterator[Tuple[str, dict]]:
        """Yield (node_dir, metadata) in DFS pre-order (the reference's
        OutofcoreDepthFirstIterator)."""
        stack = [self.root]
        while stack:
            d = stack.pop()
            meta = _read_meta(d)
            yield d, meta
            for o in reversed(range(8)):
                if meta["children"][o]:
                    stack.append(os.path.join(d, str(o)))

    def breadth_first(self) -> Iterator[Tuple[str, dict]]:
        """BFS order (OutofcoreBreadthFirstIterator)."""
        from collections import deque
        q = deque([self.root])
        while q:
            d = q.popleft()
            meta = _read_meta(d)
            yield d, meta
            for o in range(8):
                if meta["children"][o]:
                    q.append(os.path.join(d, str(o)))

    # ------------------------------------------------------------- LOD
    def build_lod(self, sample_fraction: float = 0.125,
                  max_points: int = 4096, seed: int = 0) -> None:
        """Populate every INTERNAL node with a random sample of its
        subtree (reference buildLOD: each level keeps sample_fraction of
        the level below). Post-order accumulation."""
        rng = np.random.default_rng(seed)

        def visit(node_dir: str) -> np.ndarray:
            meta = _read_meta(node_dir)
            if not any(meta["children"]):
                return _read_payload(node_dir)
            parts = [visit(os.path.join(node_dir, str(o)))
                     for o in range(8) if meta["children"][o]]
            allp = np.concatenate(parts) if parts else np.zeros((0, 3),
                                                                np.float32)
            n = min(max(1, int(len(allp) * sample_fraction)), max_points) \
                if len(allp) else 0
            if n:
                sel = rng.choice(len(allp), n, replace=False)
                _write_payload(node_dir, allp[sel], _LOD)
            return allp

        visit(self.root)

    # ----------------------------------------------------------- queries
    def query_bb_includes(self, bmin, bmax,
                          depth: Optional[int] = None) -> Cloud:
        """Points inside the box. With ``depth``, descend only that far and
        serve internal nodes' LOD payloads (queryBBIncludes w/
        query_depth) — leaves shallower than ``depth`` serve their full
        payload."""
        bmin = np.asarray(bmin, np.float64)
        bmax = np.asarray(bmax, np.float64)
        out: List[np.ndarray] = []

        def visit(node_dir: str):
            meta = _read_meta(node_dir)
            lo = np.asarray(meta["bb_min"])
            hi = np.asarray(meta["bb_max"])
            if (hi < bmin).any() or (lo > bmax).any():
                return
            is_leaf = not any(meta["children"])
            if depth is not None and meta["depth"] >= depth and not is_leaf:
                xyz = _read_payload(node_dir, _LOD)
            elif is_leaf:
                xyz = _read_payload(node_dir)
            else:
                for o in range(8):
                    if meta["children"][o]:
                        visit(os.path.join(node_dir, str(o)))
                return
            if len(xyz):
                inside = ((xyz >= bmin) & (xyz <= bmax)).all(axis=1)
                if inside.any():
                    out.append(xyz[inside])

        visit(self.root)
        if not out:
            return from_numpy(np.zeros((0, 3), np.float32), device=self.device)
        return from_numpy(np.concatenate(out), device=self.device)

    def get_occupied_voxel_centers(self, depth: int) -> np.ndarray:
        """Centers of occupied nodes at ``depth`` (nodes shallower than
        ``depth`` that are leaves count too — they own the volume)."""
        centers = []
        for d, meta in self.depth_first():
            is_leaf = not any(meta["children"])
            if meta["depth"] == depth or (is_leaf and meta["depth"] < depth):
                if meta["subtree_count"] > 0 or meta["point_count"] > 0:
                    lo = np.asarray(meta["bb_min"])
                    hi = np.asarray(meta["bb_max"])
                    centers.append(0.5 * (lo + hi))
        return np.asarray(centers) if centers \
            else np.zeros((0, 3), np.float64)

    # ------------------------------------------------------------- stats
    def tree_stats(self) -> dict:
        n_nodes = n_leaves = n_points = 0
        max_d = 0
        for _d, meta in self.depth_first():
            n_nodes += 1
            max_d = max(max_d, meta["depth"])
            if not any(meta["children"]):
                n_leaves += 1
                n_points += meta["point_count"]
        return {"nodes": n_nodes, "leaves": n_leaves, "points": n_points,
                "depth": max_d}
