"""Minimal dependency-free TIFF codec — uncompressed baseline TIFF only.

Supports grayscale 8/16-bit and RGB 8-bit, single strip or multi-strip,
little/big endian (reference consumer: tools/tiff2pcd.cpp, which converts
depth/RGB TIFF frame pairs to PCDs; the reference links VTK's TIFF reader —
here the depth-camera subset is implemented directly).

Counterpart of ``pcl_tpu/io/tiff.py`` (a copy of its numpy code; files are
byte for byte the JAX writer's).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

# tag ids
_WIDTH, _HEIGHT = 256, 257
_BITS, _COMPRESSION, _PHOTOMETRIC = 258, 259, 262
_STRIP_OFFSETS, _SAMPLES_PER_PIXEL, _ROWS_PER_STRIP = 273, 277, 278
_STRIP_COUNTS = 279

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


def _read_ifd(buf: bytes, off: int, bo: str) -> Dict[int, List[int]]:
    (n,) = struct.unpack_from(bo + "H", buf, off)
    tags: Dict[int, List[int]] = {}
    for i in range(n):
        tag, typ, cnt = struct.unpack_from(bo + "HHI", buf, off + 2 + 12 * i)
        if typ not in _TYPE_FMT:
            continue
        size = _TYPE_SIZE[typ] * cnt
        vo = off + 2 + 12 * i + 8
        if size > 4:
            (vo,) = struct.unpack_from(bo + "I", buf, vo)
        vals = list(struct.unpack_from(bo + str(cnt) + _TYPE_FMT[typ], buf, vo))
        tags[tag] = vals
    return tags


def load_tiff(path: str) -> np.ndarray:
    """Read an uncompressed TIFF. Returns [H,W] (gray) or [H,W,3] (RGB)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        bo = "<"
    elif buf[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic, ifd_off = struct.unpack_from(bo + "HI", buf, 2)
    if magic != 42:
        raise ValueError(f"{path}: bad TIFF magic {magic}")
    tags = _read_ifd(buf, ifd_off, bo)
    w = tags[_WIDTH][0]
    h = tags[_HEIGHT][0]
    comp = tags.get(_COMPRESSION, [1])[0]
    if comp != 1:
        raise ValueError(f"{path}: only uncompressed TIFF supported (compression={comp})")
    spp = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
    bits = tags.get(_BITS, [8])[0]
    if bits not in (8, 16):
        raise ValueError(f"{path}: unsupported bit depth {bits}")
    data = b"".join(
        buf[o : o + c]
        for o, c in zip(tags[_STRIP_OFFSETS], tags[_STRIP_COUNTS])
    )
    dt = np.dtype(("u1" if bits == 8 else bo + "u2"))
    img = np.frombuffer(data, dt, count=h * w * spp)
    if spp == 1:
        return img.reshape(h, w)
    return img.reshape(h, w, spp)[..., :3]


def save_tiff(path: str, img: np.ndarray) -> None:
    """Write an uncompressed little-endian TIFF (gray 8/16-bit or RGB 8)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    bits = 16 if img.dtype == np.uint16 else 8
    if bits == 8:
        img = img.astype(np.uint8)
    body = np.ascontiguousarray(img).tobytes()
    photometric = 1 if spp == 1 else 2
    entries = [
        (_WIDTH, 4, 1, w), (_HEIGHT, 4, 1, h),
        (_BITS, 3, 1, bits) if spp == 1 else None,
        (_COMPRESSION, 3, 1, 1), (_PHOTOMETRIC, 3, 1, photometric),
        (_STRIP_OFFSETS, 4, 1, 0),  # patched below
        (_SAMPLES_PER_PIXEL, 3, 1, spp), (_ROWS_PER_STRIP, 4, 1, h),
        (_STRIP_COUNTS, 4, 1, len(body)),
    ]
    bits_extra = b""
    if spp == 3:
        # BitsPerSample needs 3 shorts -> external value area
        entries[2] = (_BITS, 3, 3, None)
    entries = [e for e in entries if e is not None]
    entries.sort(key=lambda e: e[0])
    header = struct.pack("<2sHI", b"II", 42, 8)
    ifd_size = 2 + 12 * len(entries) + 4
    extra_off = 8 + ifd_size
    if spp == 3:
        bits_extra = struct.pack("<3H", bits, bits, bits) + b"\0" * 2
    data_off = extra_off + len(bits_extra)
    parts = [struct.pack("<H", len(entries))]
    for tag, typ, cnt, val in entries:
        if tag == _STRIP_OFFSETS:
            val = data_off
        if tag == _BITS and cnt == 3:
            parts.append(struct.pack("<HHII", tag, typ, cnt, extra_off))
        else:
            parts.append(struct.pack("<HHII", tag, typ, cnt, val))
    parts.append(struct.pack("<I", 0))  # next IFD
    with open(path, "wb") as f:
        f.write(header + b"".join(parts) + bits_extra + body)
