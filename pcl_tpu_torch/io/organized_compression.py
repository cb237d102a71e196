"""Organized point-cloud compression — depth/color image codec.

Capability match for pcl::io::OrganizedPointCloudCompression (reference:
io/include/pcl/compression/organized_pointcloud_compression.h +
organized_pointcloud_conversion.h): an organized cloud is converted to a
16-bit depth image (+ optional 8-bit RGB image), both compressed as PNGs,
with the camera model parameters in the header so the decoder can
re-project pixels to 3D. Invalid points encode as depth 0.

Counterpart of ``pcl_tpu/io/organized_compression.py``: a copy of its numpy
code over the port's PNG codec; blobs are the JAX package's byte for byte.
"""

from __future__ import annotations

import io as _io
import struct
import tempfile
from typing import Optional, Tuple

import numpy as np

from pcl_tpu_torch.io.png import save_png, load_png

_MAGIC = b"PTOC"  # pcl_tpu organized compression


def encode_organized(
    xyz_img: np.ndarray,
    valid: np.ndarray,
    rgb_img: Optional[np.ndarray] = None,
    focal: float = 525.0,
    depth_scale: float = 1000.0,
) -> bytes:
    """xyz_img [H,W,3] camera-frame points (z forward) -> compressed blob.
    (organized_pointcloud_compression.hpp encodePointCloud: depth
    quantized to u16 mm + PNG)."""
    H, W = xyz_img.shape[:2]
    z = np.where(valid, xyz_img[..., 2], 0.0)
    d16 = np.clip(z * depth_scale, 0, 65535).astype(np.uint16)

    def png_bytes(img):
        with tempfile.NamedTemporaryFile(suffix=".png") as tmp:
            save_png(tmp.name, img)
            tmp.seek(0)
            return open(tmp.name, "rb").read()

    depth_png = png_bytes(d16)
    rgb_png = b""
    if rgb_img is not None:
        rgb_png = png_bytes(np.clip(rgb_img * 255.0, 0, 255).astype(np.uint8))

    head = _MAGIC + struct.pack(
        "<IIffII", W, H, focal, depth_scale, len(depth_png), len(rgb_png)
    )
    return head + depth_png + rgb_png


def decode_organized(blob: bytes) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Returns (xyz_img [H,W,3], valid [H,W], rgb [H,W,3] or None):
    pixels re-projected through the pinhole model."""
    if blob[:4] != _MAGIC:
        raise ValueError("not an organized-compression blob")
    W, H, focal, depth_scale, n_d, n_c = struct.unpack("<IIffII", blob[4:28])
    pos = 28
    with tempfile.NamedTemporaryFile(suffix=".png") as tmp:
        tmp.write(blob[pos : pos + n_d])
        tmp.flush()
        d16 = load_png(tmp.name)
    pos += n_d
    rgb = None
    if n_c:
        with tempfile.NamedTemporaryFile(suffix=".png") as tmp:
            tmp.write(blob[pos : pos + n_c])
            tmp.flush()
            rgb = load_png(tmp.name).astype(np.float32) / 255.0

    z = d16.astype(np.float32) / depth_scale
    valid = z > 0
    u = np.arange(W, dtype=np.float32) - W / 2.0
    v = np.arange(H, dtype=np.float32) - H / 2.0
    x = u[None, :] * z / focal
    y = v[:, None] * z / focal
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    return xyz, valid, rgb
