"""Stereo — adaptive-cost 2-pass scanline optimization + digital elevation maps.

- ``adaptive_cost_so_matching``: pcl::AdaptiveCostSOStereoMatching
  (reference: stereo/include/pcl/stereo/stereo_matching.h:428) — per-pixel
  SAD costs weighted by color/proximity adaptive windows, then a
  left->right + right->left scanline optimization (1D semi-global
  smoothing with P1/P2 penalties).
- ``disparity_to_dem``: pcl::DigitalElevationMapBuilder (stereo/include/
  pcl/stereo/digital_elevation_map.h) — project disparities to 3D, then
  bin into a (column, disparity) grid and average heights per cell.

Counterpart of ``pcl_tpu/stereo/advanced.py``. The adaptive weights wrap
the top and bottom rows into each other, and the right view's costs wrap
columns, as the JAX module's ``jnp.roll`` does; its ``lax.scan`` over the
columns is a loop of torch ops over the ``W`` columns, each step on the
``[H, D]`` slice (ROADMAP C89). Division by the default ``gamma_c`` is a
product with its float32 reciprocal, as XLA forms a division by a
constant (C79). The DEM adds its heights through ``ops.segsum.add_rows``,
in index order on either device (C84, C90).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.ops.segsum import add_rows


def _recip32(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def adaptive_costs(L: torch.Tensor, R: torch.Tensor, max_disparity: int, radius: int,
                   gamma_c: float, gamma_s: float) -> torch.Tensor:
    """``[H, W, D]`` adaptive-weight SAD costs: weights from the colour
    similarity to the window's centre and the vertical distance (a
    vertical-only Yoon-Kweon window); ``1e4`` where ``x < d``."""
    H, W = L.shape
    inv_c = _recip32(gamma_c)
    xx = torch.arange(W, device=L.device)[None, :]
    wgts = [torch.exp(-(torch.roll(L, dy, 0) - L).abs() * inv_c - float(np.float32(abs(dy) / gamma_s)))
            for dy in range(-radius, radius + 1)]
    den = torch.zeros_like(L)
    for wgt in wgts:
        den = den + wgt
    den = torch.clamp(den, min=1e-6)
    out = []
    for d in range(max_disparity):
        ad = (L - torch.roll(R, d, 1)).abs()
        num = torch.zeros_like(ad)
        for dy, wgt in zip(range(-radius, radius + 1), wgts):
            num = num + wgt * torch.roll(ad, dy, 0)
        out.append(torch.where(xx >= d, num / den, 1e4))
    return torch.stack(out, -1)


def _so_pass(cv: torch.Tensor, P1: float, P2: float) -> torch.Tensor:
    """Scanline optimization along +x of ``[H, W, D]`` costs: each column's
    ``[H, D]`` slice aggregated from the one before it."""
    H, W, D = cv.shape
    prev = torch.zeros((H, D), dtype=cv.dtype, device=cv.device)
    big = torch.full((H, 1), 1e9, dtype=cv.dtype, device=cv.device)
    out = []
    for x in range(W):
        pmin = prev.min(1, keepdim=True).values
        shift_p = torch.cat([big, prev[:, :-1]], 1)
        shift_n = torch.cat([prev[:, 1:], big], 1)
        prev = cv[:, x] + torch.minimum(torch.minimum(prev, pmin + P2),
                                        torch.minimum(shift_p + P1, shift_n + P1)) - pmin
        out.append(prev)
    return torch.stack(out, 1)


def adaptive_aggregate(left: torch.Tensor, right: torch.Tensor, max_disparity: int = 64,
                       radius: int = 2, gamma_c: float = 15.0, gamma_s: float = 17.5,
                       smoothness_weak: float = 20.0,
                       smoothness_strong: float = 120.0) -> torch.Tensor:
    """``[H, W, D]`` costs after both scanline passes."""
    cost = adaptive_costs(left.to(torch.float32), right.to(torch.float32), max_disparity,
                          radius, gamma_c, gamma_s)
    fwd = _so_pass(cost, smoothness_weak, smoothness_strong)
    bwd = _so_pass(cost.flip(1), smoothness_weak, smoothness_strong).flip(1)
    return fwd + bwd


def adaptive_cost_so_matching(
    left: torch.Tensor,
    right: torch.Tensor,
    max_disparity: int = 64,
    radius: int = 2,
    gamma_c: float = 15.0,
    gamma_s: float = 17.5,
    smoothness_weak: float = 20.0,
    smoothness_strong: float = 120.0,
    lr_tolerance: int = 1,
) -> torch.Tensor:
    """Disparity [H,W] f32, invalid = -1."""
    H, W = left.shape
    agg = adaptive_aggregate(left, right, max_disparity, radius, gamma_c, gamma_s,
                             smoothness_weak, smoothness_strong)
    disp = torch.argmin(agg, -1).to(torch.float32)
    # left-right consistency: C_R(x, d) = C_L(x + d, d), columns wrapping
    rcost = torch.stack([torch.roll(agg[..., d], -d, 1) for d in range(max_disparity)], -1)
    rdisp = torch.argmin(rcost, -1).to(torch.float32)
    xx = torch.arange(W, device=left.device)[None, :].to(torch.float32)
    xr = torch.clamp(xx - disp, 0, W - 1).to(torch.int64)
    rd = torch.gather(rdisp, 1, xr)
    ok = ((disp - rd).abs() <= lr_tolerance) & (xx >= disp)
    return torch.where(ok, disp, -1.0)


def disparity_to_dem(
    disparity: torch.Tensor,
    intensity: torch.Tensor,
    focal: float,
    baseline: float,
    cx: float,
    cy: float,
    dem_cols: int = 64,
    dem_disp_bins: int = 32,
    min_disparity: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build a (dem_cols x dem_disp_bins) elevation grid: cells average the
    3D height (y) of pixels falling in each (image-column, disparity) bin.
    Returns (height [C,B], count [C,B])."""
    H, W = disparity.shape
    dev = disparity.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    focal_t = f32(focal)
    valid = disparity >= min_disparity
    d = torch.where(valid, disparity, 1.0)
    z = focal_t * f32(baseline) / d
    yy = (torch.arange(H, device=dev)[:, None].to(torch.float32) - f32(cy)) * z / focal_t
    col_bin = (torch.arange(W, device=dev)[None, :] * dem_cols // W).expand(H, W)
    dmax = torch.where(valid, disparity, 0.0).max() + f32(1e-6)
    disp_bin = torch.clamp(xla_int32(disparity / dmax * f32(dem_disp_bins)), 0,
                           dem_disp_bins - 1)
    key = col_bin * dem_disp_bins + disp_bin
    key = torch.where(valid, key, dem_cols * dem_disp_bins).reshape(-1)
    n = dem_cols * dem_disp_bins + 1
    flat_h = add_rows(torch.zeros(n, dtype=torch.float32, device=dev), key,
                      torch.where(valid, yy, 0.0).reshape(-1))
    flat_c = add_rows(torch.zeros(n, dtype=torch.float32, device=dev), key,
                      valid.to(torch.float32).reshape(-1))
    height = (flat_h / torch.clamp(flat_c, min=1.0))[:-1].reshape(dem_cols, dem_disp_bins)
    count = flat_c[:-1].reshape(dem_cols, dem_disp_bins)
    return height, count
