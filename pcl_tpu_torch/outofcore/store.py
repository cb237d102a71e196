"""Disk-paged octree store.

Layout (reference octree_base organizes one folder per node with .oct_idx
JSON + point payloads; here one folder per TOP-LEVEL cell, flat):

  root/
    meta.json                    resolution, split_depth, bounds, counts
    nodes/<morton>.pcd           full-resolution points of that cell
    lod/<level>/<morton>.pcd     subsampled payloads per shallower level

Insertion appends per-cell (read-modify-write per touched node — the
reference's disk containers do the same); LOD levels are random samples
(the reference's random-sampled LOD construction).

Counterpart of ``pcl_tpu/outofcore/store.py``: a copy of its numpy code, the
node files written by the port's PCD writer. The store works on host rows;
the clouds that queries return are placed on the store's ``device``
(default CUDA).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, from_numpy, to_numpy
from pcl_tpu_torch.io import pcd

_HOST = "cpu"       # node files are read and written through host clouds


def _morton_np(cells: np.ndarray) -> np.ndarray:
    def spread(v):
        v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v
    return (spread(cells[:, 0]) | (spread(cells[:, 1]) << np.uint64(1))
            | (spread(cells[:, 2]) << np.uint64(2)))


class OutofcoreOctree:
    def __init__(self, root: str, device=None):
        self.root = root
        self.device = device
        with open(os.path.join(root, "meta.json")) as f:
            self.meta = json.load(f)

    # ---- creation -------------------------------------------------------
    @classmethod
    def create(
        cls,
        root: str,
        cell_size: float,
        origin=(0.0, 0.0, 0.0),
        split_depth: int = 4,
        lod_levels: int = 3,
        lod_points: int = 4096,
        device=None,
    ) -> "OutofcoreOctree":
        os.makedirs(os.path.join(root, "nodes"), exist_ok=True)
        for lv in range(lod_levels):
            os.makedirs(os.path.join(root, "lod", str(lv)), exist_ok=True)
        meta = {
            "cell_size": cell_size,
            "origin": list(origin),
            "split_depth": split_depth,
            "lod_levels": lod_levels,
            "lod_points": lod_points,
            "n_points": 0,
        }
        with open(os.path.join(root, "meta.json"), "w") as f:
            json.dump(meta, f)
        return cls(root, device=device)

    def _cell_of(self, xyz: np.ndarray) -> np.ndarray:
        m = self.meta
        # top-level cell size covers 2^split_depth leaf cells
        top = m["cell_size"] * (1 << m["split_depth"])
        return np.floor((xyz - np.asarray(m["origin"])) / top).astype(np.int64)

    def add_cloud(self, cloud: Cloud) -> None:
        xyz, _ = to_numpy(cloud, compact=True)
        cells = self._cell_of(xyz)
        if (cells < 0).any() or (cells >= (1 << 21)).any():
            raise ValueError("points outside the addressable volume")
        keys = _morton_np(cells.astype(np.uint64))
        order = np.argsort(keys)
        keys_s = keys[order]
        xyz_s = xyz[order]
        boundaries = np.flatnonzero(np.diff(keys_s)) + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(keys_s)]])
        for s, e in zip(starts, ends):
            key = int(keys_s[s])
            path = os.path.join(self.root, "nodes", f"{key:016x}.pcd")
            pts = xyz_s[s:e]
            if os.path.exists(path):
                old = to_numpy(pcd.load(path, device=_HOST))[0]
                pts = np.concatenate([old, pts])
            pcd.save(path, from_numpy(pts, device=_HOST))
            self._update_lod(key, pts)
        self.meta["n_points"] += len(xyz)
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump(self.meta, f)

    def _update_lod(self, key: int, pts: np.ndarray) -> None:
        rng = np.random.default_rng(key & 0xFFFFFFFF)
        cap = self.meta["lod_points"]
        for lv in range(self.meta["lod_levels"]):
            n = max(1, min(len(pts), cap >> lv))
            sel = rng.choice(len(pts), n, replace=False) if n < len(pts) \
                else np.arange(len(pts))
            pcd.save(os.path.join(self.root, "lod", str(lv), f"{key:016x}.pcd"),
                     from_numpy(pts[sel], device=_HOST))

    # ---- queries --------------------------------------------------------
    def node_keys(self) -> List[int]:
        files = os.listdir(os.path.join(self.root, "nodes"))
        return sorted(int(f.split(".")[0], 16) for f in files if f.endswith(".pcd"))

    def _node_path(self, key: int, lod: Optional[int]) -> str:
        sub = os.path.join("lod", str(lod)) if lod is not None else "nodes"
        return os.path.join(self.root, sub, f"{key:016x}.pcd")

    def _node_rows(self, key: int, lod: Optional[int]) -> np.ndarray:
        return to_numpy(pcd.load(self._node_path(key, lod), device=_HOST))[0]

    def read_node(self, key: int, lod: Optional[int] = None) -> Cloud:
        return pcd.load(self._node_path(key, lod), device=self.device)

    def query_box(
        self, bmin, bmax, lod: Optional[int] = None
    ) -> Cloud:
        """All points (at the chosen LOD) whose node intersects the box,
        post-filtered to the box (reference queryBBIncludes)."""
        m = self.meta
        top = m["cell_size"] * (1 << m["split_depth"])
        org = np.asarray(m["origin"])
        bmin = np.asarray(bmin, np.float64)
        bmax = np.asarray(bmax, np.float64)
        clouds = []
        for key in self.node_keys():
            cell = self._demorton(key)
            lo = org + cell * top
            hi = lo + top
            if (hi < bmin).any() or (lo > bmax).any():
                continue
            xyz = self._node_rows(key, lod)
            inside = ((xyz >= bmin) & (xyz <= bmax)).all(axis=1)
            if inside.any():
                clouds.append(xyz[inside])
        if not clouds:
            return from_numpy(np.zeros((0, 3), np.float32), device=self.device)
        return from_numpy(np.concatenate(clouds), device=self.device)

    def query_frustum(self, planes: np.ndarray,
                      lod: Optional[int] = None) -> Cloud:
        """All points (at the chosen LOD) inside a convex frustum given as
        [P,4] inward-facing plane coefficients (n·x + d >= 0 inside) —
        the queryFrustum path of the reference's disk octree
        (outofcore/include/pcl/outofcore/octree_base.h:150 family).
        Nodes are culled when their cube is entirely outside any plane."""
        m = self.meta
        top = m["cell_size"] * (1 << m["split_depth"])
        org = np.asarray(m["origin"])
        planes = np.asarray(planes, np.float64)
        clouds = []
        for key in self.node_keys():
            cell = self._demorton(key)
            lo = org + cell * top
            hi = lo + top
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            d = corners @ planes[:, :3].T + planes[None, :, 3]
            if (d < 0).all(axis=0).any():   # all corners outside one plane
                continue
            xyz = self._node_rows(key, lod)
            inside = (xyz @ planes[:, :3].T + planes[None, :, 3] >= 0).all(axis=1)
            if inside.any():
                clouds.append(xyz[inside])
        if not clouds:
            return from_numpy(np.zeros((0, 3), np.float32), device=self.device)
        return from_numpy(np.concatenate(clouds), device=self.device)

    @staticmethod
    def _demorton(key: int) -> np.ndarray:
        def compact(v):
            v = v & 0x1249249249249249
            v = (v | (v >> 2)) & 0x10C30C30C30C30C3
            v = (v | (v >> 4)) & 0x100F00F00F00F00F
            v = (v | (v >> 8)) & 0x1F0000FF0000FF
            v = (v | (v >> 16)) & 0x1F00000000FFFF
            v = (v | (v >> 32)) & 0x1FFFFF
            return v
        return np.array([compact(key), compact(key >> 1), compact(key >> 2)])
