"""PLY reader and writer.

Counterpart of ``pcl_tpu/io/ply.py`` (a copy of its numpy code, so that the
port imports nothing of the JAX package): ascii, binary_little_endian and
binary_big_endian bodies, any scalar vertex properties, and list properties
(faces come back from ``load_mesh``). x/y/z become the cloud's points,
nx/ny/nz its ``normal``, red/green/blue(/alpha) its ``rgb`` in [0, 1], other
properties attributes of the same name. ``device`` places the cloud (default
CUDA, as every constructor of the port).
"""

from __future__ import annotations

import io as _io
from typing import Dict, List, Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, from_numpy, to_numpy

_PLY_TYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}
_INV_PLY = {
    np.dtype(np.int8): "char", np.dtype(np.uint8): "uchar",
    np.dtype(np.int16): "short", np.dtype(np.uint16): "ushort",
    np.dtype(np.int32): "int", np.dtype(np.uint32): "uint",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}


class _Element:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        self.properties: List[Tuple] = []   # ("scalar", name, dtype) or
                                            # ("list", name, count_dtype, item_dtype)


def _parse_header(f) -> Tuple[List[_Element], str]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[_Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            if len(tokens) < 2:
                raise ValueError("malformed PLY format line")
            fmt = tokens[1]
        elif tokens[0] == "element":
            if len(tokens) < 3:
                raise ValueError("malformed PLY element line")
            count = int(tokens[2])
            if count < 0:
                raise ValueError("negative PLY element count")
            elements.append(_Element(tokens[1], count))
        elif tokens[0] == "property":
            if not elements:
                raise ValueError("property before element in PLY header")
            if len(tokens) < 3:
                raise ValueError("malformed PLY property line")
            if tokens[1] == "list":
                if len(tokens) < 5:
                    raise ValueError("malformed PLY list property line")
                elements[-1].properties.append(
                    ("list", tokens[4], _PLY_TYPES[tokens[2]], _PLY_TYPES[tokens[3]])
                )
            else:
                elements[-1].properties.append(
                    ("scalar", tokens[2], _PLY_TYPES[tokens[1]])
                )
        elif tokens[0] == "end_header":
            break
        else:
            raise ValueError(f"unknown PLY header line: {tokens[0]}")
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return elements, fmt


def _read_element_ascii(f, el: _Element):
    has_list = any(p[0] == "list" for p in el.properties)
    if not has_list:
        names = [p[1] for p in el.properties]
        dtypes = [p[2] for p in el.properties]
        rows = np.loadtxt(
            _io.BytesIO(b"".join(f.readline() for _ in range(el.count))),
            dtype=np.float64, ndmin=2,
        )
        if rows.size == 0:
            rows = rows.reshape(0, len(names))
        if rows.shape[1] != len(names) or rows.shape[0] != el.count:
            raise ValueError("PLY ascii body shape mismatch")
        return {n: rows[:, i].astype(dt) for i, (n, dt) in enumerate(zip(names, dtypes))}
    out: Dict[str, list] = {p[1]: [] for p in el.properties}
    for _ in range(el.count):
        tokens = f.readline().split()
        k = 0
        for p in el.properties:
            if p[0] == "list":
                if k >= len(tokens):
                    raise ValueError("short PLY ascii row")
                cnt = int(tokens[k]); k += 1
                if cnt < 0 or k + cnt > len(tokens):
                    raise ValueError("bad PLY list count")
                out[p[1]].append(np.array(tokens[k:k + cnt], dtype=p[3]))
                k += cnt
            else:
                if k >= len(tokens):
                    raise ValueError("short PLY ascii row")
                out[p[1]].append(p[2](float(tokens[k]))); k += 1
    return {k: (np.stack(v) if v and isinstance(v[0], np.ndarray)
                and all(len(a) == len(v[0]) for a in v) else v)
            for k, v in out.items()}


def _read_element_binary(f, el: _Element, byteorder: str):
    bo = "<" if byteorder == "little" else ">"
    has_list = any(p[0] == "list" for p in el.properties)
    if not has_list:
        dt = np.dtype([(p[1], bo + np.dtype(p[2]).str[1:]) for p in el.properties])
        raw = f.read(dt.itemsize * el.count)
        arr = np.frombuffer(raw, dtype=dt, count=el.count)
        return {p[1]: arr[p[1]].copy() for p in el.properties}
    out: Dict[str, list] = {p[1]: [] for p in el.properties}
    for _ in range(el.count):
        for p in el.properties:
            if p[0] == "list":
                cdt = np.dtype(p[2]).newbyteorder(bo)
                raw = f.read(cdt.itemsize)
                if len(raw) < cdt.itemsize:
                    raise ValueError("unexpected EOF in PLY list count")
                cnt = int(np.frombuffer(raw, cdt)[0])
                if cnt < 0:
                    raise ValueError("negative PLY list count")
                idt = np.dtype(p[3]).newbyteorder(bo)
                raw = f.read(idt.itemsize * cnt)
                if len(raw) < idt.itemsize * cnt:
                    raise ValueError("unexpected EOF in PLY list body")
                out[p[1]].append(np.frombuffer(raw, idt).copy())
            else:
                sdt = np.dtype(p[2]).newbyteorder(bo)
                raw = f.read(sdt.itemsize)
                if len(raw) < sdt.itemsize:
                    raise ValueError("unexpected EOF in PLY body")
                out[p[1]].append(np.frombuffer(raw, sdt)[0])
    return {k: (np.stack(v) if v and isinstance(v[0], np.ndarray)
                and all(len(a) == len(v[0]) for a in v) else v)
            for k, v in out.items()}


def _vertex_to_cloud(vert: Dict[str, np.ndarray], capacity=None, device=None) -> Cloud:
    xyz = np.stack([vert.pop("x"), vert.pop("y"), vert.pop("z")], axis=1).astype(np.float32)
    attrs: Dict[str, np.ndarray] = {}
    if all(k in vert for k in ("nx", "ny", "nz")):
        attrs["normal"] = np.stack(
            [vert.pop("nx"), vert.pop("ny"), vert.pop("nz")], axis=1
        ).astype(np.float32)
    if all(k in vert for k in ("red", "green", "blue")):
        attrs["rgb"] = np.stack(
            [vert.pop("red"), vert.pop("green"), vert.pop("blue")], axis=1
        ).astype(np.float32) / 255.0
        vert.pop("alpha", None)
    for k, v in vert.items():
        v = np.asarray(v)
        v = v.astype(v.dtype.newbyteorder("="))      # torch takes native order only
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        attrs[k] = v
    return from_numpy(xyz, attrs, capacity=capacity, device=device)


def load(path, capacity=None, device=None) -> Cloud:
    """Read the vertex element as a Cloud on ``device``."""
    cloud, _faces = load_mesh(path, capacity=capacity, device=device)
    return cloud


def _body_size_guard(f, elements, fmt) -> None:
    """Reject absurd element counts BEFORE looping/allocating: the body
    cannot possibly be shorter than count * (minimal row size). Bounds both
    allocation and parse-loop length for hostile headers (fuzz contract)."""
    pos = f.tell()
    f.seek(0, 2)
    remaining = f.tell() - pos
    f.seek(pos)
    need = 0
    for el in elements:
        if fmt == "ascii":
            # >= "0 " per property, minus 1: the very last value of the
            # last row may be a single byte with no trailing newline
            row = 2 * max(len(el.properties), 1)
            need += max(el.count * row - 1, 0)
        else:
            row = sum(np.dtype(p[2]).itemsize for p in el.properties)
            need += el.count * row
    if need > remaining:
        raise ValueError(
            f"PLY body too short: header promises >= {need} bytes, "
            f"{remaining} present")


def load_mesh(path, capacity=None, device=None) -> Tuple[Cloud, Optional[np.ndarray]]:
    """Read ``(vertex cloud on device, face index array [F, 3] or None)``."""
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        _body_size_guard(f, elements, fmt)
        data = {}
        for el in elements:
            if fmt == "ascii":
                data[el.name] = _read_element_ascii(f, el)
            else:
                data[el.name] = _read_element_binary(
                    f, el, "little" if fmt == "binary_little_endian" else "big"
                )
    if "vertex" not in data:
        raise ValueError("PLY file has no vertex element")
    cloud = _vertex_to_cloud(data["vertex"], capacity, device)
    faces = None
    face_el = data.get("face")
    if face_el:
        for key in ("vertex_indices", "vertex_index"):
            if key in face_el:
                fl = face_el[key]
                if isinstance(fl, np.ndarray):
                    faces = fl.astype(np.int32)
                elif fl and all(len(a) == 3 for a in fl):
                    faces = np.stack(fl).astype(np.int32)
                else:
                    faces = [np.asarray(a, np.int32) for a in fl]
                break
    return cloud, faces


def save(path, cloud: Cloud, binary: bool = True,
         faces: Optional[np.ndarray] = None,
         byte_order: str = "little") -> None:
    """Write a Cloud (and optional triangle faces) as PLY.

    ``byte_order``: 'little' or 'big' for the binary body (the reference
    writer/reader handle both, io/src/ply_io.cpp)."""
    if byte_order not in ("little", "big"):
        raise ValueError("byte_order must be 'little' or 'big'")
    bo = "<" if byte_order == "little" else ">"
    xyz, attrs = to_numpy(cloud, compact=True)
    n = len(xyz)
    cols: List[Tuple[str, np.ndarray]] = [
        ("x", xyz[:, 0].astype(np.float32)),
        ("y", xyz[:, 1].astype(np.float32)),
        ("z", xyz[:, 2].astype(np.float32)),
    ]
    if "normal" in attrs:
        nm = attrs.pop("normal")
        cols += [("nx", nm[:, 0].astype(np.float32)),
                 ("ny", nm[:, 1].astype(np.float32)),
                 ("nz", nm[:, 2].astype(np.float32))]
    if "rgb" in attrs:
        c = np.clip(attrs.pop("rgb") * 255.0 + 0.5, 0, 255).astype(np.uint8)
        cols += [("red", c[:, 0]), ("green", c[:, 1]), ("blue", c[:, 2])]
    for k, v in attrs.items():
        v = np.asarray(v)
        if v.ndim == 1:
            cols.append((k, v))
        else:
            for j in range(v.shape[1]):
                cols.append((f"{k}_{j}", v[:, j]))

    header = ["ply"]
    header.append(f"format binary_{byte_order}_endian 1.0" if binary
                  else "format ascii 1.0")
    header.append("comment generated by pcl_tpu_torch")
    header.append(f"element vertex {n}")
    for name, v in cols:
        header.append(f"property {_INV_PLY[np.dtype(v.dtype)]} {name}")
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            dt = np.dtype([(name, bo + np.dtype(v.dtype).str[1:]) for name, v in cols])
            rec = np.empty(n, dtype=dt)
            for name, v in cols:
                rec[name] = v
            f.write(rec.tobytes())
            if faces is not None:
                faces = np.asarray(faces, np.int32)
                fdt = np.dtype([("c", np.uint8), ("i", bo + "i4", (3,))])
                frec = np.empty(len(faces), dtype=fdt)
                frec["c"] = 3
                frec["i"] = faces
                f.write(frec.tobytes())
        else:
            body = np.stack([v.astype(np.float64) for _n, v in cols], axis=1)
            for row, orig in zip(body, range(n)):
                f.write((" ".join(
                    format(int(x), "d") if np.issubdtype(cols[j][1].dtype, np.integer)
                    else format(float(x), ".9g")
                    for j, x in enumerate(row)
                ) + "\n").encode("ascii"))
            if faces is not None:
                for face in np.asarray(faces, np.int32):
                    f.write((f"3 {face[0]} {face[1]} {face[2]}\n").encode("ascii"))
