"""Pyramidal Lucas-Kanade feature tracking (PCL's ``PyramidalKLTTracker``).

Counterpart of ``pcl_tpu/tracking/klt.py``: intensity pyramids of both
frames (a rolled 5-point blur, then 2 x 2 means), then from the coarsest
level down every track refined together by Gauss-Newton over a fixed window,
the windows one ``[K, W^2]`` bilinear gather and the 2 x 2 normal equations
solved in closed form.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import _device

# XLA divides by the constant 5 as a product with its float32 reciprocal (ROADMAP C79)
_FIFTH = float(np.float32(1.0) / np.float32(5.0))


def _pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    out = [img]
    cur = img
    for _ in range(levels - 1):
        H, W = cur.shape
        blur = (cur + torch.roll(cur, 1, 0) + torch.roll(cur, -1, 0)
                + torch.roll(cur, 1, 1) + torch.roll(cur, -1, 1)) * _FIFTH
        cur = blur[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2).mean((1, 3))
        out.append(cur)
    return out


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    y = torch.clamp(y, 0.0, H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y0 = xla_int32(torch.floor(y)).long()
    x0 = xla_int32(torch.floor(x)).long()
    fy = y - y0
    fx = x - x0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def _track_level(prev_img: torch.Tensor, next_img: torch.Tensor, pts_prev: torch.Tensor,
                 guess: torch.Tensor, window_radius: int, iterations: int):
    """One pyramid level of refinement from ``guess``; points ``[K, 2]``
    (y, x). Returns ``(displacement [K, 2], well-conditioned [K])``."""
    r = window_radius
    dev = prev_img.device
    dy, dx = torch.meshgrid(torch.arange(-r, r + 1, device=dev),
                            torch.arange(-r, r + 1, device=dev), indexing="ij")
    offs = torch.stack([dy.reshape(-1), dx.reshape(-1)], 1).to(torch.float32)

    def window(img, centres):
        return _bilinear(img, centres[:, 0:1] + offs[None, :, 0],
                         centres[:, 1:2] + offs[None, :, 1])

    Iw = window(prev_img, pts_prev)
    gy = window(torch.roll(prev_img, -1, 0) - torch.roll(prev_img, 1, 0), pts_prev) * 0.5
    gx = window(torch.roll(prev_img, -1, 1) - torch.roll(prev_img, 1, 1), pts_prev) * 0.5
    A11 = torch.sum(gy * gy, 1)
    A12 = torch.sum(gy * gx, 1)
    A22 = torch.sum(gx * gx, 1)
    det = A11 * A22 - A12 * A12
    dd = torch.clamp(det, min=1e-8)
    d = guess
    for _ in range(iterations):
        err = window(next_img, pts_prev + d) - Iw
        b1 = torch.sum(err * gy, 1)
        b2 = torch.sum(err * gx, 1)
        d = d + torch.stack([-(A22 * b1 - A12 * b2) / dd, -(-A12 * b1 + A11 * b2) / dd], 1)
    return d, det > 1e-4


def pyramidal_klt(prev_img, next_img, points, levels: int = 3, window_radius: int = 4,
                  iterations: int = 10, max_residual: float = 1e3, device=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Track ``[K, 2]`` (y, x) points from one frame to the next on
    ``device`` (default CUDA): ``(new points [K, 2] float32, status [K])``,
    status False where a level's window was ill-conditioned or the point
    left the image."""
    dev = _device(device)
    a = torch.as_tensor(np.asarray(prev_img, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(next_img, np.float32), device=dev)
    pa = _pyramid(a, levels)
    pb = _pyramid(b, levels)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    d = torch.zeros_like(pts)
    ok_all = torch.ones(len(pts), dtype=torch.bool, device=dev)
    for lvl in range(levels - 1, -1, -1):
        scale = 1 << lvl
        d, ok = _track_level(pa[lvl], pb[lvl], pts / scale,
                             d * 2.0 if lvl < levels - 1 else d / scale, window_radius,
                             iterations)
        ok_all &= ok
    new_pts = pts + d
    H, W = a.shape
    inb = (new_pts[:, 0] >= 0) & (new_pts[:, 0] < H) & (new_pts[:, 1] >= 0) & (new_pts[:, 1] < W)
    return new_pts.cpu().numpy(), (ok_all & inb).cpu().numpy()
