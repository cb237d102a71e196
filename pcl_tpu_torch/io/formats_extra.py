"""Extra cloud/mesh formats — IFS, legacy VTK, TAR-of-PCDs.

- IFS (reference: io/include/pcl/io/ifs_io.h): the Brown Indexed Face Set
  binary format — header magic "IFS", version float, name, VERTICES +
  TRIANGLES sections with u32 counts and f32 triples.
- VTK legacy ASCII polydata (reference: io/include/pcl/io/vtk_io.h
  saveVTKFile / vtk_lib_io.h loadPolygonFileVTK): POINTS + POLYGONS/VERTICES
  sections; we read/write the `# vtk DataFile` v3 dialect PCL emits.
- TAR of PCDs (reference: io/include/pcl/io/tar.h + pcd_grabber tar
  support): a POSIX ustar archive whose members are .pcd files.

Counterpart of ``pcl_tpu/io/formats_extra.py`` (a copy of its numpy code;
IFS and VTK files are byte for byte the JAX writer's, the tar's members
are written by the port's PCD writer). ``device`` places a loaded cloud
(default CUDA).
"""

from __future__ import annotations

import os
import struct
import tarfile
from typing import List, Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, make_cloud
from pcl_tpu_torch.io import pcd as pcd_io


# ----------------------------------------------------------------- IFS

_IFS_MAGIC = "IFS"


def _ifs_string(s: str) -> bytes:
    b = s.encode() + b"\x00"
    return struct.pack("<I", len(b)) + b


def _read_ifs_string(f) -> str:
    (n,) = struct.unpack("<I", f.read(4))
    return f.read(n).rstrip(b"\x00").decode()


def save_ifs(path: str, vertices: np.ndarray, triangles: Optional[np.ndarray] = None,
             name: str = "pcl_tpu") -> None:
    v = np.asarray(vertices, np.float32)
    with open(path, "wb") as f:
        f.write(_ifs_string(_IFS_MAGIC))
        f.write(struct.pack("<f", 1.0))
        f.write(_ifs_string(name))
        f.write(_ifs_string("VERTICES"))
        f.write(struct.pack("<I", len(v)))
        f.write(v.astype("<f4").tobytes())
        if triangles is not None and len(triangles):
            t = np.asarray(triangles, np.uint32)
            f.write(_ifs_string("TRIANGLES"))
            f.write(struct.pack("<I", len(t)))
            f.write(t.astype("<u4").tobytes())


def load_ifs(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (vertices [V,3] f32, triangles [F,3] u32 or None)."""
    with open(path, "rb") as f:
        if _read_ifs_string(f) != _IFS_MAGIC:
            raise ValueError("not an IFS file")
        struct.unpack("<f", f.read(4))  # version
        _read_ifs_string(f)  # model name
        verts = None
        tris = None
        while True:
            try:
                section = _read_ifs_string(f)
            except struct.error:
                break
            (n,) = struct.unpack("<I", f.read(4))
            if section == "VERTICES":
                verts = np.frombuffer(f.read(12 * n), "<f4").reshape(n, 3).copy()
            elif section == "TRIANGLES":
                tris = np.frombuffer(f.read(12 * n), "<u4").reshape(n, 3).copy()
            else:
                break
    if verts is None:
        raise ValueError("IFS file has no VERTICES section")
    return verts, tris


def load_ifs_cloud(path: str, device=None) -> Cloud:
    verts, _ = load_ifs(path)
    return make_cloud(verts, device=device)


# ----------------------------------------------------------------- VTK

def save_vtk(path: str, vertices: np.ndarray,
             polygons: Optional[np.ndarray] = None) -> None:
    """Legacy VTK ASCII polydata (vtk_io.h saveVTKFile). With no polygons a
    VERTICES section marks every point (point-cloud convention)."""
    v = np.asarray(vertices, np.float64)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\npcl_tpu output\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {len(v)} float\n")
        for p in v:
            f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
        if polygons is not None and len(polygons):
            t = np.asarray(polygons, np.int64)
            f.write(f"POLYGONS {len(t)} {len(t) * (t.shape[1] + 1)}\n")
            for row in t:
                f.write(str(t.shape[1]) + " " + " ".join(map(str, row)) + "\n")
        else:
            f.write(f"VERTICES {len(v)} {2 * len(v)}\n")
            for i in range(len(v)):
                f.write(f"1 {i}\n")


def load_vtk(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (points [N,3] f32, polygons [F,k] i32 or None)."""
    pts: List[List[float]] = []
    polys: List[List[int]] = []
    with open(path) as f:
        tokens: List[str] = []
        mode = None
        want = 0
        for line in f:
            s = line.split()
            if not s:
                continue
            if s[0] == "POINTS":
                mode, want = "points", int(s[1]) * 3
                tokens = []
                continue
            if s[0] in ("POLYGONS", "VERTICES", "LINES"):
                mode, want = ("polys" if s[0] == "POLYGONS" else "skip"), int(s[2])
                tokens = []
                continue
            if s[0] in ("POINT_DATA", "CELL_DATA"):
                mode = None
                continue
            if mode == "points":
                tokens.extend(s)
                while len(tokens) >= 3 and len(pts) * 3 < want:
                    pts.append([float(tokens.pop(0)) for _ in range(3)])
                if len(pts) * 3 >= want:
                    mode = None
            elif mode == "polys":
                vals = list(map(int, s))
                k = vals[0]
                polys.append(vals[1 : 1 + k])
    p = np.asarray(pts, np.float32)
    t = np.asarray(polys, np.int32) if polys and all(
        len(q) == len(polys[0]) for q in polys
    ) else (polys or None)
    return p, t


def load_vtk_cloud(path: str, device=None) -> Cloud:
    pts, _ = load_vtk(path)
    return make_cloud(pts, device=device)


# ----------------------------------------------------------------- TAR

def save_tar_pcds(path: str, clouds: List[Cloud], prefix: str = "frame") -> None:
    """Pack clouds as {prefix}_{i:06d}.pcd members of a ustar archive."""
    import tempfile

    with tarfile.open(path, "w") as tf:
        for i, c in enumerate(clouds):
            with tempfile.NamedTemporaryFile(suffix=".pcd", delete=False) as tmp:
                tmp_path = tmp.name
            try:
                pcd_io.save(tmp_path, c)
                tf.add(tmp_path, arcname=f"{prefix}_{i:06d}.pcd")
            finally:
                os.unlink(tmp_path)


def load_tar_pcds(path: str, device=None) -> List[Cloud]:
    """Read every .pcd member (pcd_grabber.h TAR streaming, eager form)."""
    import tempfile

    out = []
    with tarfile.open(path, "r") as tf:
        for m in tf.getmembers():
            if not m.name.lower().endswith(".pcd"):
                continue
            data = tf.extractfile(m).read()
            with tempfile.NamedTemporaryFile(suffix=".pcd", delete=False) as tmp:
                tmp.write(data)
                tmp_path = tmp.name
            try:
                out.append(pcd_io.load(tmp_path, device=device))
            finally:
                os.unlink(tmp_path)
    return out
