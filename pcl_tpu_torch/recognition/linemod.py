"""LINEMOD: multimodal template matching on quantised feature maps.

Counterpart of ``pcl_tpu/recognition/linemod.py`` (PCL's linemod.h,
line_rgbd.h, color_gradient_modality.h, surface_normal_modality.h,
quantized_map.h). Two modalities quantise a per-pixel direction into 8 bins
(the strongest colour channel's gradient; the in-plane direction of the
surface normal); the bins are OR-spread over a window; a template's sparse
features score every image offset at once, one shifted plane per feature.

Traits of the reference kept here (ROADMAP C77): every shift wraps around
the image border (``jnp.roll``), and the spread covers ``2 (spread // 2) +
1`` pixels a side (5 x 5 at the default 4). A colour channel's squared
gradient is formed as XLA's CPU code fuses ``gx gx + gy gy`` (one fused
multiply-add), so the channel chosen and the threshold decide alike; the
direction goes through ``atan2``, whose last bit differs between torch and
XLA on some inputs, so a pixel within rounding of a bin edge may take the
neighbouring bin (C78). Template extraction and the detections' suppression
run on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.ops.nn1 import _fma32

_N_BINS = 8


def _as_tensor(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=_device(device))


def _roll(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, (dy, dx), (0, 1))


def _bins(ang: torch.Tensor) -> torch.Tensor:
    """8 half-orientation bins of ``atan2(...) % pi``."""
    a = torch.remainder(ang, math.pi)
    return torch.remainder(xla_int32(torch.floor(a / math.pi * _N_BINS)), _N_BINS)


def color_gradient_quantized(rgb, gradient_threshold: float = 10.0, device=None
                             ) -> torch.Tensor:
    """``[H, W]`` int32 bin in [0, 8), or -1 where the strongest channel's
    squared gradient is not above ``gradient_threshold ** 2``."""
    img = _as_tensor(rgb, device, torch.float32)
    shape = img.shape[:2]
    gx = torch.zeros(shape, dtype=torch.float32, device=img.device)
    gy = torch.zeros_like(gx)
    mag = torch.full(shape, -1.0, device=img.device)
    for c in range(img.shape[2]):
        ch = img[..., c]
        cgx = (_roll(ch, 0, -1) - _roll(ch, 0, 1)) * 0.5
        cgy = (_roll(ch, -1, 0) - _roll(ch, 1, 0)) * 0.5
        cmag = _fma32(cgx, cgx, cgy * cgy)
        upd = cmag > mag
        gx = torch.where(upd, cgx, gx)
        gy = torch.where(upd, cgy, gy)
        mag = torch.maximum(mag, cmag)
    thr = np.float32(gradient_threshold)
    return torch.where(mag > float(thr * thr), _bins(torch.atan2(gy, gx)), -1)


def surface_normal_quantized(xyz_img, valid, device=None) -> torch.Tensor:
    """``[H, W]`` int32 bin in [0, 8) of the normal's in-image direction,
    from central-difference tangents; -1 where a tangent's pixel is
    invalid."""
    xyz = _as_tensor(xyz_img, device, torch.float32)
    valid = _as_tensor(valid, xyz.device, torch.bool)
    dx = (_roll(xyz, 0, -1) - _roll(xyz, 0, 1)) * 0.5
    dy = (_roll(xyz, -1, 0) - _roll(xyz, 1, 0)) * 0.5
    n = torch.linalg.cross(dx, dy, dim=-1)
    nn = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)
    ok = valid & _roll(valid, 0, -1) & _roll(valid, 0, 1) & _roll(valid, -1, 0) \
        & _roll(valid, 1, 0)
    return torch.where(ok, _bins(torch.atan2(nn[..., 1], nn[..., 0])), -1)


def spread_quantized_map(qmap, spread: int = 4, device=None) -> torch.Tensor:
    """``[H, W, 8]`` bool: the bin is present within ``spread // 2`` pixels
    (quantized_map.h spreadQuantizedMap)."""
    q = _as_tensor(qmap, device, torch.int64)
    onehot = torch.nn.functional.one_hot(torch.clamp(q, 0, _N_BINS - 1), _N_BINS).to(torch.bool)
    onehot &= (q >= 0)[..., None]
    out = onehot.clone()
    r = spread // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out |= _roll(onehot, dy, dx)
    return out


@dataclass
class LinemodTemplate:
    offsets: np.ndarray   # [F, 2] int32 (dy, dx) relative to the region's corner
    bins: np.ndarray      # [F] int32
    modality: np.ndarray  # [F] int32 (0 gradient, 1 normal)
    height: int
    width: int


def extract_template(qmaps: List[np.ndarray], region: Tuple[int, int, int, int],
                     n_features: int = 63, seed: int = 0) -> LinemodTemplate:
    """Up to ``n_features`` quantised pixels of the region ``(y0, x0, h,
    w)`` across the modalities (linemod.h createAndAddTemplate), drawn with
    numpy's ``default_rng(seed)``."""
    y0, x0, h, w = region
    rng = np.random.default_rng(seed)
    offs, bins, mods = [], [], []
    for m, qm in enumerate(qmaps):
        qm = qm.cpu().numpy() if isinstance(qm, torch.Tensor) else np.asarray(qm)
        sub = qm[y0:y0 + h, x0:x0 + w]
        yy, xx = np.nonzero(sub >= 0)
        if len(yy) == 0:
            continue
        take = min(n_features // len(qmaps) + 1, len(yy))
        sel = rng.choice(len(yy), size=take, replace=False)
        offs.append(np.stack([yy[sel], xx[sel]], 1))
        bins.append(sub[yy[sel], xx[sel]])
        mods.append(np.full(take, m))
    if not offs:
        raise ValueError("no quantizable features in region")
    return LinemodTemplate(np.concatenate(offs).astype(np.int32),
                           np.concatenate(bins).astype(np.int32),
                           np.concatenate(mods).astype(np.int32), h, w)


def _score_map(spread_maps: torch.Tensor, offsets: np.ndarray, bins: np.ndarray,
               modality: np.ndarray, th: int, tw: int) -> torch.Tensor:
    """``[H, W]`` share of the template's features present at every
    top-left offset; 0 where the template would leave the image.
    ``spread_maps [M, H, W, 8]`` bool."""
    H, W = spread_maps.shape[1:3]
    acc = torch.zeros((H, W), dtype=torch.float32, device=spread_maps.device)
    for (dy, dx), b, m in zip(offsets.tolist(), bins.tolist(), modality.tolist()):
        acc = acc + _roll(spread_maps[m, :, :, b], -dy, -dx).to(torch.float32)
    # XLA divides by the constant feature count as a product with its
    # float32 reciprocal
    score = acc * float(np.float32(1.0 / offsets.shape[0]))
    yy = torch.arange(H, device=acc.device)[:, None]
    xx = torch.arange(W, device=acc.device)[None, :]
    return torch.where((yy <= H - th) & (xx <= W - tw), score, 0.0)


@dataclass
class LinemodDetection:
    y: int
    x: int
    score: float
    template_id: int


def detect_templates(spread_maps, templates: List[LinemodTemplate], threshold: float = 0.8,
                     max_detections: int = 8, device=None) -> List[LinemodDetection]:
    """Score each template at every offset, then greedy suppression over
    half-template windows on the host (linemod.h detectTemplates)."""
    if all(isinstance(s, torch.Tensor) for s in spread_maps):
        sm = torch.stack([s.to(torch.bool) for s in spread_maps])
    else:
        sm = _as_tensor(np.stack([np.asarray(s) for s in spread_maps]), device, torch.bool)
    out = []
    for tid, t in enumerate(templates):
        s = _score_map(sm, np.asarray(t.offsets), np.asarray(t.bins), np.asarray(t.modality),
                       t.height, t.width).cpu().numpy()
        for _ in range(max_detections):
            yx = np.unravel_index(s.argmax(), s.shape)
            v = s[yx]
            if v < threshold:
                break
            out.append(LinemodDetection(int(yx[0]), int(yx[1]), float(v), tid))
            y0 = max(0, yx[0] - t.height // 2)
            x0 = max(0, yx[1] - t.width // 2)
            s[y0:yx[0] + t.height // 2 + 1, x0:yx[1] + t.width // 2 + 1] = 0
    out.sort(key=lambda d: -d.score)
    return out


def build_modality_maps(rgb, xyz_img, valid, gradient_threshold: float = 10.0,
                        device=None) -> List[torch.Tensor]:
    """The quantised (unspread) maps of both modalities, for template
    extraction."""
    qg = color_gradient_quantized(rgb, gradient_threshold, device=device)
    qn = surface_normal_quantized(xyz_img, valid, device=qg.device)
    return [qg, qn]


def line_rgbd_detect(rgb, xyz_img, valid, templates: List[LinemodTemplate],
                     gradient_threshold: float = 10.0, spread: int = 4,
                     threshold: float = 0.8, device=None) -> List[LinemodDetection]:
    """The LineRGBD path: quantise both modalities, spread, detect."""
    qg, qn = build_modality_maps(rgb, xyz_img, valid, gradient_threshold, device)
    return detect_templates([spread_quantized_map(qg, spread), spread_quantized_map(qn, spread)],
                            templates, threshold)
