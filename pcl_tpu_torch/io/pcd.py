"""PCD file format reader/writer.

Counterpart of ``pcl_tpu/io/pcd.py``: the PCD v0.7 format with ASCII, binary
and binary_compressed (LZF over field-major data) bodies and the header
fields VERSION / FIELDS / SIZE / TYPE / COUNT / WIDTH / HEIGHT / VIEWPOINT /
POINTS / DATA. A file written by either package loads in the other.

Files are parsed on the host with numpy; ``load`` then places the cloud on
``device`` (default CUDA, as every constructor of the port).
Well-known fields map onto Cloud attributes:

- ``x y z``                          -> ``Cloud.xyz``
- ``normal_x normal_y normal_z``     -> attr ``normal`` [N,3]
- ``rgb``/``rgba`` (packed)          -> attr ``rgb`` [N,3] float in [0,1]
- ``curvature``/``intensity``/``label`` -> same-named attrs
- anything else                      -> attr under its own field name
  (COUNT>1 fields, e.g. FPFH descriptors, become [N,COUNT] arrays)
"""

from __future__ import annotations

import io as _io
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, from_numpy, to_numpy
from pcl_tpu_torch.io import lzf

_TYPE_MAP = {
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32, ("I", 8): np.int64,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32, ("U", 8): np.uint64,
    ("F", 4): np.float32, ("F", 8): np.float64,
}
_INV_TYPE = {v: k for k, v in _TYPE_MAP.items()}


@dataclass
class PCDHeader:
    fields: List[str] = field(default_factory=list)
    sizes: List[int] = field(default_factory=list)
    types: List[str] = field(default_factory=list)
    counts: List[int] = field(default_factory=list)
    width: int = 0
    height: int = 1
    viewpoint: Tuple[float, ...] = (0, 0, 0, 1, 0, 0, 0)
    points: int = 0
    data: str = "ascii"

    @property
    def dtypes(self) -> List[np.dtype]:
        return [np.dtype(_TYPE_MAP[(t, s)]) for t, s in zip(self.types, self.sizes)]

    @property
    def point_step(self) -> int:
        return sum(s * c for s, c in zip(self.sizes, self.counts))


def _parse_header(stream) -> PCDHeader:
    h = PCDHeader()
    while True:
        line = stream.readline()
        if not line:
            raise ValueError("PCD: unexpected EOF in header")
        if isinstance(line, bytes):
            line = line.decode("ascii", errors="replace")
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        key = key.upper()
        vals = rest.split()
        if key in ("WIDTH", "HEIGHT", "POINTS", "DATA") and not vals:
            raise ValueError(f"PCD: header key {key} has no value")
        if key == "VERSION":
            pass
        elif key == "FIELDS" or key == "COLUMNS":
            h.fields = vals
        elif key == "SIZE":
            h.sizes = [int(v) for v in vals]
        elif key == "TYPE":
            h.types = vals
        elif key == "COUNT":
            h.counts = [int(v) for v in vals]
        elif key == "WIDTH":
            h.width = int(vals[0])
        elif key == "HEIGHT":
            h.height = int(vals[0])
        elif key == "VIEWPOINT":
            h.viewpoint = tuple(float(v) for v in vals)
        elif key == "POINTS":
            h.points = int(vals[0])
        elif key == "DATA":
            h.data = vals[0].lower()
            break
        else:
            raise ValueError(f"PCD: unknown header key {key!r}")
    if not h.counts:
        h.counts = [1] * len(h.fields)
    if not h.points:
        h.points = h.width * h.height
    if not h.width:
        h.width, h.height = h.points, 1
    # structural validation before anything sizes an allocation off these
    if not (len(h.fields) == len(h.sizes) == len(h.types) == len(h.counts)):
        raise ValueError("PCD: FIELDS/SIZE/TYPE/COUNT length mismatch")
    if h.points < 0 or h.width < 0 or h.height < 0:
        raise ValueError("PCD: negative dimensions")
    if any(c < 1 for c in h.counts) or any(s < 1 for s in h.sizes):
        raise ValueError("PCD: non-positive SIZE/COUNT")
    return h


def _read_body(h: PCDHeader, stream) -> Dict[str, np.ndarray]:
    """Returns {field_name: [points, count] array} in file field order."""
    n = h.points
    out: Dict[str, np.ndarray] = {}
    if h.data == "ascii":
        text = stream.read()
        if isinstance(text, bytes):
            text = text.decode("ascii", errors="replace")
        ncols = sum(h.counts)
        arr = np.array(text.split(), dtype=np.float64)
        if arr.size < n * ncols:
            raise ValueError(f"PCD ascii: expected {n*ncols} values, got {arr.size}")
        arr = arr[: n * ncols].reshape(n, ncols)
        col = 0
        for name, dt, c in zip(h.fields, h.dtypes, h.counts):
            out[name] = arr[:, col:col + c].astype(dt)
            col += c
    elif h.data == "binary":
        step = h.point_step
        raw = stream.read(n * step)
        if len(raw) < n * step:
            raise ValueError("PCD binary: truncated body")
        rec_dtype = np.dtype({
            "names": h.fields,
            "formats": [(dt, (c,)) if c > 1 else dt for dt, c in zip(h.dtypes, h.counts)],
            "offsets": np.cumsum([0] + [s * c for s, c in zip(h.sizes, h.counts)][:-1]).tolist(),
            "itemsize": step,
        })
        rec = np.frombuffer(raw, dtype=rec_dtype, count=n)
        for name, c in zip(h.fields, h.counts):
            v = rec[name]
            out[name] = v.reshape(n, c) if c > 1 else v.reshape(n, 1)
    elif h.data == "binary_compressed":
        sizes = stream.read(8)
        if len(sizes) < 8:
            raise ValueError("PCD binary_compressed: truncated size header")
        comp_size, uncomp_size = struct.unpack("<II", sizes)
        # the uncompressed blob is exactly the field-major body; a hostile
        # header must not size an unbounded allocation
        expected = n * h.point_step
        if uncomp_size != expected:
            raise ValueError(
                f"PCD binary_compressed: uncompressed size {uncomp_size} "
                f"!= body size {expected}")
        comp = stream.read(comp_size)
        if len(comp) < comp_size:
            raise ValueError("PCD binary_compressed: truncated body")
        raw = lzf.decompress(comp, uncomp_size)
        # field-major layout: each field's n*count values consecutive
        offset = 0
        for name, dt, c in zip(h.fields, h.dtypes, h.counts):
            nbytes = n * c * dt.itemsize
            out[name] = np.frombuffer(raw[offset:offset + nbytes], dtype=dt).reshape(n, c)
            offset += nbytes
    else:
        raise ValueError(f"PCD: unsupported DATA {h.data!r}")
    return out


def _unpack_rgb(col: np.ndarray, is_float: bool) -> np.ndarray:
    """PCL packs rgb(a) into a uint32, stored as its float32 bit pattern."""
    if is_float:
        u = col.astype(np.float32).view(np.uint32)
    else:
        u = col.astype(np.uint32)
    r = ((u >> 16) & 0xFF).astype(np.float32) / 255.0
    g = ((u >> 8) & 0xFF).astype(np.float32) / 255.0
    b = (u & 0xFF).astype(np.float32) / 255.0
    return np.stack([r, g, b], axis=1)


def _pack_rgb(rgb: np.ndarray) -> np.ndarray:
    r = np.clip(rgb[:, 0] * 255.0 + 0.5, 0, 255).astype(np.uint32)
    g = np.clip(rgb[:, 1] * 255.0 + 0.5, 0, 255).astype(np.uint32)
    b = np.clip(rgb[:, 2] * 255.0 + 0.5, 0, 255).astype(np.uint32)
    return ((r << 16) | (g << 8) | b).astype(np.uint32)


def read_pcd_arrays(path_or_file) -> Tuple[PCDHeader, Dict[str, np.ndarray]]:
    """Low-level: header + raw per-field arrays."""
    if hasattr(path_or_file, "read"):
        h = _parse_header(path_or_file)
        return h, _read_body(h, path_or_file)
    with open(path_or_file, "rb") as f:
        h = _parse_header(f)
        return h, _read_body(h, f)


def load(path_or_file, capacity: Optional[int] = None, keep_invalid: bool = False,
         device=None) -> Cloud:
    """Read a PCD file into a Cloud on ``device`` (default CUDA). Non-finite
    xyz rows become masked padding (organized clouds keep their rows so
    width/height stay valid, with mask=False where the sensor returned NaN)."""
    h, cols = read_pcd_arrays(path_or_file)
    n = h.points
    fl = {f.lower(): f for f in h.fields}

    def col(name):
        return cols[fl[name]].reshape(n, -1)

    if all(k in fl for k in ("x", "y", "z")):
        xyz = np.concatenate([col("x")[:, :1], col("y")[:, :1], col("z")[:, :1]], axis=1).astype(np.float32)
    else:
        raise ValueError(f"PCD: no x/y/z fields in {h.fields}")

    attrs: Dict[str, np.ndarray] = {}
    consumed = {"x", "y", "z"}
    if all(k in fl for k in ("normal_x", "normal_y", "normal_z")):
        attrs["normal"] = np.concatenate(
            [col("normal_x")[:, :1], col("normal_y")[:, :1], col("normal_z")[:, :1]], axis=1
        ).astype(np.float32)
        consumed |= {"normal_x", "normal_y", "normal_z"}
    for packed in ("rgb", "rgba"):
        if packed in fl:
            i = h.fields.index(fl[packed])
            attrs["rgb"] = _unpack_rgb(col(packed)[:, 0], h.types[i] == "F")
            consumed.add(packed)
            break
    for simple in ("curvature", "intensity"):
        if simple in fl:
            attrs[simple] = col(simple)[:, 0].astype(np.float32)
            consumed.add(simple)
    if "label" in fl:
        attrs["label"] = col("label")[:, 0].astype(np.int32)
        consumed.add("label")
    for f in h.fields:
        if f.lower() not in consumed and f != "_":
            v = cols[f]
            attrs[f] = v[:, 0] if v.shape[1] == 1 else v

    organized = h.height > 1
    cloud = from_numpy(
        xyz, attrs,
        capacity=capacity,
        drop_nonfinite=not keep_invalid,
        width=h.width if organized else 0,
        height=h.height if organized else 1,
        device=device,
    )
    return cloud


def save(path, cloud: Cloud, data: str = "binary_compressed",
         viewpoint: Tuple[float, ...] = (0, 0, 0, 1, 0, 0, 0),
         compact: bool = True) -> None:
    """Write a Cloud to PCD. ``data`` in {ascii, binary, binary_compressed}."""
    xyz, attrs = to_numpy(cloud, compact=compact and not cloud.is_organized)
    n = len(xyz)
    names: List[str] = ["x", "y", "z"]
    cols: List[np.ndarray] = [xyz[:, 0:1], xyz[:, 1:2], xyz[:, 2:3]]
    types: List[str] = ["F"] * 3
    sizes: List[int] = [4] * 3

    def add(name, arr, t, s):
        names.append(name); cols.append(arr.reshape(n, -1)); types.append(t); sizes.append(s)

    for key, v in attrs.items():
        if key == "normal":
            for i, ax in enumerate(("normal_x", "normal_y", "normal_z")):
                add(ax, v[:, i].astype(np.float32), "F", 4)
        elif key == "rgb":
            add("rgb", _pack_rgb(v).view(np.float32), "F", 4)
        elif key == "label":
            add("label", v.astype(np.uint32), "U", 4)
        else:
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating):
                add(key, v.astype(np.float32), "F", 4)
            elif np.issubdtype(v.dtype, np.unsignedinteger):
                add(key, v.astype(np.uint32), "U", 4)
            else:
                add(key, v.astype(np.int32), "I", 4)

    counts = [c.shape[1] for c in cols]
    width = cloud.width if cloud.is_organized else n
    height = cloud.height if cloud.is_organized else 1
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {' '.join(str(s) for s in sizes)}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join(str(c) for c in counts)}\n"
        f"WIDTH {width}\n"
        f"HEIGHT {height}\n"
        f"VIEWPOINT {' '.join(f'{v:g}' for v in viewpoint)}\n"
        f"POINTS {n}\n"
        f"DATA {data}\n"
    )

    close = False
    if hasattr(path, "write"):
        f = path
    else:
        f = open(path, "wb")
        close = True
    try:
        f.write(header.encode("ascii"))
        if data == "ascii":
            buf = _io.StringIO()
            full = np.concatenate([c.astype(np.float64) for c in cols], axis=1)
            np.savetxt(buf, full, fmt="%.9g")
            f.write(buf.getvalue().encode("ascii"))
        elif data == "binary":
            dts = [np.dtype(_TYPE_MAP[(t, s)]) for t, s in zip(types, sizes)]
            rec_dtype = np.dtype({
                "names": names,
                "formats": [(dt, (c,)) if c > 1 else dt for dt, c in zip(dts, counts)],
            })
            rec = np.zeros(n, dtype=rec_dtype)
            for name, c, dt, colv in zip(names, counts, dts, cols):
                rec[name] = colv.astype(dt).reshape(rec[name].shape)
            f.write(rec.tobytes())
        elif data == "binary_compressed":
            dts = [np.dtype(_TYPE_MAP[(t, s)]) for t, s in zip(types, sizes)]
            # field-major (SoA) reorder: each field's per-point values stay
            # contiguous per point (row-major within the field block)
            blob = b"".join(np.ascontiguousarray(colv.astype(dt)).tobytes() for colv, dt in zip(cols, dts))
            comp = lzf.compress(blob)
            f.write(struct.pack("<II", len(comp), len(blob)))
            f.write(comp)
        else:
            raise ValueError(f"unsupported DATA {data!r}")
    finally:
        if close:
            f.close()
