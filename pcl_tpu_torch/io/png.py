"""PNG image I/O — dependency-free reader/writer over stdlib zlib.

Counterpart of ``pcl_tpu/io/png.py`` (a copy of its numpy code, so that the
port imports nothing of the JAX package; files are byte for byte the JAX
writer's).

Capability match for pcl::io::savePNGFile / loadPNGFile and the depth/RGB
image helpers (reference: io/include/pcl/io/png_io.h — the reference links
libpng; here the PNG container is implemented directly: critical chunks
IHDR/IDAT/IEND, filter types 0-4, 8/16-bit grayscale and RGB/RGBA).

Used by organized-cloud compression (organized_pointcloud_compression.h
encodes depth as 16-bit PNG + color as 8-bit RGB PNG).
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def save_png(path: str, img: np.ndarray) -> None:
    """Write [H,W] (grayscale, u8/u16) or [H,W,3|4] u8 image."""
    img = np.asarray(img)
    if img.ndim == 2:
        color_type = 0
        depth = 16 if img.dtype == np.uint16 else 8
        arr = img.astype(">u2" if depth == 16 else np.uint8)
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, depth = 2, 8
        arr = img.astype(np.uint8)
    elif img.ndim == 3 and img.shape[2] == 4:
        color_type, depth = 6, 8
        arr = img.astype(np.uint8)
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    H, W = arr.shape[:2]
    raw = arr.tobytes()
    stride = len(raw) // H
    # filter 0 per scanline
    body = b"".join(
        b"\x00" + raw[y * stride : (y + 1) * stride] for y in range(H)
    )
    ihdr = struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(body, 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(data: bytes, H: int, stride: int, bpp: int) -> bytearray:
    out = bytearray(H * stride)
    pos = 0
    prev = bytearray(stride)
    for y in range(H):
        ft = data[pos]
        pos += 1
        row = bytearray(data[pos : pos + stride])
        pos += stride
        if ft == 1:  # Sub
            for i in range(bpp, stride):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ft == 2:  # Up
            for i in range(stride):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 3:  # Average
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pr) & 0xFF
        out[y * stride : (y + 1) * stride] = row
        prev = row
    return out


def load_png(path: str) -> np.ndarray:
    """Read a PNG written by save_png (or any non-interlaced 8/16-bit
    grayscale / RGB / RGBA PNG)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    W = H = depth = color_type = None
    idat = b""
    while pos < len(buf):
        (ln,) = struct.unpack(">I", buf[pos : pos + 4])
        tag = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            W, H, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", data
            )
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"IDAT":
            idat += data
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    bpp = max(1, channels * depth // 8)
    stride = (W * channels * depth + 7) // 8
    raw = _unfilter(zlib.decompress(idat), H, stride, bpp)
    if depth == 16:
        arr = np.frombuffer(bytes(raw), ">u2").reshape(H, W, channels)
        arr = arr.astype(np.uint16)
    else:
        arr = np.frombuffer(bytes(raw), np.uint8).reshape(H, W, channels)
    return arr[..., 0] if channels == 1 else arr


def save_depth_png(path: str, depth_m: np.ndarray, scale: float = 1000.0) -> None:
    """Depth in meters -> 16-bit millimeter PNG (png_io.h saveShortPNGFile)."""
    d = np.clip(np.nan_to_num(depth_m) * scale, 0, 65535).astype(np.uint16)
    save_png(path, d)


def load_depth_png(path: str, scale: float = 1000.0) -> np.ndarray:
    return load_png(path).astype(np.float32) / scale


def save_rgb_png(path: str, rgb01: np.ndarray) -> None:
    """RGB floats in [0,1] -> 8-bit PNG (png_io.h saveRgbPNGFile)."""
    save_png(path, np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8))


def load_rgb_png(path: str) -> np.ndarray:
    return load_png(path).astype(np.float32) / 255.0
