"""Wavefront OBJ reader (reference: io/include/pcl/io/obj_io.h — vertices,
vertex normals and faces; MTL materials are ignored for point-cloud use).

Counterpart of ``pcl_tpu/io/obj.py``: polygons are fan-triangulated, and
``vn`` rows become the cloud's ``normal`` only when there are as many as
``v`` rows. Like the JAX module it defines no writer (``io.save`` of an
``.obj`` path raises ``ImportError`` in both packages, ROADMAP C86).
``device`` places the cloud (default CUDA).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, from_numpy


def load(path, capacity=None, device=None) -> Cloud:
    cloud, _ = load_mesh(path, capacity=capacity, device=device)
    return cloud


def load_mesh(path, capacity=None, device=None) -> Tuple[Cloud, Optional[np.ndarray]]:
    verts, normals, faces = [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "vn":
                normals.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "f":
                # f v/vt/vn triplets; triangulate fans
                idx = [int(tok.split("/")[0]) - 1 for tok in t[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    xyz = np.asarray(verts, np.float32).reshape(-1, 3)
    attrs = {}
    if normals and len(normals) == len(verts):
        attrs["normal"] = np.asarray(normals, np.float32)
    fc = np.asarray(faces, np.int32) if faces else None
    return from_numpy(xyz, attrs, capacity=capacity, device=device), fc
