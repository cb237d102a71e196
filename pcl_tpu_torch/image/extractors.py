"""Organized-cloud image extraction + bearing-angle image.

- Image extractors: equivalents of pcl::io::PointCloudImageExtractor*
  (reference: io/include/pcl/io/point_cloud_image_extractors.h) — pull
  per-field images out of organized clouds: normals -> rgb8, rgb -> rgb8,
  label -> mono16 / random-rgb / distinct-palette, z / curvature /
  intensity -> mono16 with the reference's scaling modes (fixed factor,
  full range, none). Images return as numpy arrays ([H,W] uint16 or
  [H,W,3] uint8) rather than byte-blob PCLImage structs.
- ``bearing_angle_image``: pcl::BearingAngleImage (reference:
  common/src/bearing_angle_image.cpp) — gray = angle(point(j,i+1),
  point(j+1,i)) * 255 / 180 at pixel (i+1, j), exact to the reference's
  uint8 truncation.

Counterpart of ``pcl_tpu/image/extractors.py``: each extractor reads the
cloud back to the host once and then runs the JAX module's numpy code, so
the images are bit for bit the JAX package's for the same cloud.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import (
    Cloud,
    ATTR_NORMAL,
    ATTR_RGB,
    ATTR_LABEL,
    ATTR_CURVATURE,
    ATTR_INTENSITY,
)


def _host(t) -> np.ndarray:
    """A tensor of the cloud, read back to the host."""
    return t.detach().cpu().numpy()


def _grid(cloud: Cloud) -> Tuple[int, int]:
    h, w = cloud.height, cloud.width
    if h <= 0 or w <= 0 or h * w != cloud.capacity:
        raise ValueError("image extraction requires an organized cloud")
    return h, w


def extract_normal_image(cloud: Cloud) -> np.ndarray:
    """[H,W,3] uint8: (n + 1)/2 * 254 per channel
    (PointCloudImageExtractorFromNormalField, :201)."""
    h, w = _grid(cloud)
    n = _host(cloud.attrs[ATTR_NORMAL]).reshape(h, w, 3)
    return ((n + 1.0) * 0.5 * 254.0).astype(np.uint8)


def extract_rgb_image(cloud: Cloud) -> np.ndarray:
    """[H,W,3] uint8 from the rgb attr (:228). Accepts 0..1 floats or
    0..255 values."""
    h, w = _grid(cloud)
    rgb = _host(cloud.attrs[ATTR_RGB]).reshape(h, w, 3)
    if rgb.dtype.kind == "f" and rgb.max() <= 1.0 + 1e-6:
        rgb = rgb * 255.0
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _distinct_palette(n: int) -> np.ndarray:
    """Deterministic maximally-distinct label palette. Capability match
    for the reference's Glasbey LUT (common/src/colors.cpp) — same
    mechanism (fixed lookup of perceptually spread colors), different
    constants (generated by golden-ratio hue stepping instead of the
    published Glasbey table)."""
    i = np.arange(n)
    hue = (i * 0.61803398875) % 1.0
    sat = np.where(i % 3 == 0, 1.0, 0.65 + 0.35 * ((i % 7) / 6.0))
    val = 0.65 + 0.35 * ((i % 5) / 4.0)
    c = (val * sat)[:, None]
    hp = hue * 6.0
    x = c[:, 0] * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(x)
    sel = np.stack([np.stack([c[:, 0], x, z], 1), np.stack([x, c[:, 0], z], 1),
                    np.stack([z, c[:, 0], x], 1), np.stack([z, x, c[:, 0]], 1),
                    np.stack([x, z, c[:, 0]], 1), np.stack([c[:, 0], z, x], 1)])
    rgb = sel[np.clip(hp.astype(int), 0, 5), np.arange(n)]
    m = (val - c[:, 0])[:, None]
    return np.clip((rgb + m) * 255.0, 0, 255).astype(np.uint8)


def extract_label_image(cloud: Cloud, color_mode: str = "mono") -> np.ndarray:
    """Label field image (PointCloudImageExtractorFromLabelField, :257).

    ``color_mode``: 'mono' -> [H,W] uint16 raw labels; 'rgb_random' ->
    [H,W,3] uint8, random color per label (deterministic seed, equal
    labels share a color); 'rgb_glasbey' -> [H,W,3] uint8 where the
    i-th DISTINCT label (ascending) takes the i-th palette color."""
    h, w = _grid(cloud)
    lab = _host(cloud.attrs[ATTR_LABEL]).reshape(h, w).astype(np.int64)
    if color_mode == "mono":
        return lab.astype(np.uint16)
    uniq, inv = np.unique(lab, return_inverse=True)
    if color_mode == "rgb_random":
        rng = np.random.default_rng(42)
        colors = rng.integers(0, 256, (len(uniq), 3), dtype=np.uint8)
    elif color_mode == "rgb_glasbey":
        colors = _distinct_palette(len(uniq))
    else:
        raise ValueError(f"unknown color mode {color_mode}")
    return colors[inv].reshape(h, w, 3)


def _scaled_mono16(img: np.ndarray, scaling: str, factor: float) -> np.ndarray:
    if scaling == "fixed":
        out = img * factor
    elif scaling == "full_range":
        lo, hi = np.nanmin(img), np.nanmax(img)
        rng = hi - lo
        out = (img - lo) / rng * 65535.0 if rng > 0 else np.zeros_like(img)
    elif scaling == "no":
        out = img
    else:
        raise ValueError(f"unknown scaling {scaling}")
    return np.clip(np.nan_to_num(out), 0, 65535).astype(np.uint16)


def extract_z_image(cloud: Cloud, scaling: str = "fixed",
                    factor: float = 10000.0) -> np.ndarray:
    """[H,W] uint16 of z (default: fixed factor 10000 — meters to 0.1mm,
    PointCloudImageExtractorFromZField :314)."""
    h, w = _grid(cloud)
    z = _host(cloud.xyz[:, 2]).reshape(h, w)
    return _scaled_mono16(z, scaling, factor)


def extract_curvature_image(cloud: Cloud,
                            scaling: str = "full_range",
                            factor: float = 1.0) -> np.ndarray:
    """[H,W] uint16 of curvature (default full-range scaling, :356)."""
    h, w = _grid(cloud)
    c = _host(cloud.attrs[ATTR_CURVATURE]).reshape(h, w)
    return _scaled_mono16(c, scaling, factor)


def extract_intensity_image(cloud: Cloud, scaling: str = "no",
                            factor: float = 1.0) -> np.ndarray:
    """[H,W] uint16 of intensity (default unscaled, :398)."""
    h, w = _grid(cloud)
    i = _host(cloud.attrs[ATTR_INTENSITY]).reshape(h, w)
    return _scaled_mono16(i, scaling, factor)


def bearing_angle_image(cloud: Cloud) -> np.ndarray:
    """[H,W] uint8 bearing-angle grays (BearingAngleImage::generateBAImage,
    common/src/bearing_angle_image.cpp:64): pixel (i+1, j) holds
    angle(p(j, i+1), p(j+1, i)) * 255 / 180 truncated to uint8; the first
    row and last column stay 0 (unobserved)."""
    h, w = _grid(cloud)
    p = _host(cloud.xyz).reshape(h, w, 3).astype(np.float64)
    p1 = p[1:, :-1]          # (j, i+1)
    p2 = p[:-1, 1:]          # (j+1, i)
    a = (p1 * p1).sum(-1)
    b = ((p1 - p2) ** 2).sum(-1)
    c = (p2 * p2).sum(-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        ct = (a + b - c) / (2.0 * np.sqrt(a) * np.sqrt(b))
        theta = np.degrees(np.arccos(np.clip(ct, -1.0, 1.0)))
    theta = np.where((a != 0) & (b != 0), theta, 0.0)
    out = np.zeros((h, w), np.uint8)
    out[1:, :-1] = (theta * 255.0 / 180.0).astype(np.uint8)
    return out
