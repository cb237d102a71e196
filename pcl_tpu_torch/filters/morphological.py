"""Morphological ground filtering for LiDAR.

Counterpart of ``pcl_tpu/filters/morphological.py`` (PCL's
applyMorphologicalOperator and ProgressiveMorphologicalFilter, Zhang et al.
2003). The points are rasterised to a ``[grid, grid]`` minimum-z image over x
and y (z is up), grey-scale erosion and dilation run on the image as window
minima and maxima (``max_pool2d`` with the padding of XLA's "SAME"
``reduce_window``), and each point reads its cell back.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import Cloud

_BIG = 1e30


def _rasterize_min(cloud: Cloud, resolution: float, grid: int):
    """Minimum-z raster ``[grid, grid]`` (``inf`` where empty) and each
    point's cell ``[N, 2]``, from the masked bounding box's lower corner."""
    origin = torch.amin(torch.where(cloud.mask[:, None], cloud.xyz, math.inf), dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)[:2]
    cell = torch.clamp(xla_int32(torch.floor((cloud.xyz[:, :2] - origin) / resolution)).long(),
                       0, grid - 1)
    flat = torch.where(cloud.mask, cell[:, 0] * grid + cell[:, 1], grid * grid)
    z = torch.where(cloud.mask, cloud.xyz[:, 2], _BIG)
    raster = torch.full((grid * grid + 1,), math.inf, dtype=torch.float32, device=z.device)
    raster = raster.scatter_reduce(0, flat, z, "amin")[:-1]
    raster = torch.where(raster >= _BIG, math.inf, raster).reshape(grid, grid)
    return raster, cell


def _window_max(img: torch.Tensor, size: int, fill: float) -> torch.Tensor:
    """Maximum over a ``size x size`` window, "SAME" padding with ``fill``."""
    lo, hi = (size - 1) // 2, size // 2
    padded = F.pad(img[None, None], (lo, hi, lo, hi), value=fill)
    return F.max_pool2d(padded, size, stride=1)[0, 0]


def _erode(img: torch.Tensor, size: int) -> torch.Tensor:
    return -_window_max(-img, size, -math.inf)


def _dilate(img: torch.Tensor, size: int) -> torch.Tensor:
    return _window_max(img, size, -math.inf)


def morphological_filter(cloud: Cloud, resolution: float, window_size: int = 3,
                         operator: str = "open", grid: int = 512) -> torch.Tensor:
    """The morphological surface at each point's cell, ``[N]`` z values;
    ``operator`` in {erode, dilate, open, close}."""
    raster, cell = _rasterize_min(cloud, resolution, grid)
    img = torch.where(torch.isfinite(raster), raster, _BIG)
    empty_low = torch.where(img >= _BIG, -math.inf, img)
    if operator == "erode":
        out = _erode(img, window_size)
    elif operator == "dilate":
        out = _dilate(empty_low, window_size)
    elif operator == "open":
        out = _dilate(_erode(img, window_size), window_size)
    elif operator == "close":
        out = _erode(_dilate(empty_low, window_size), window_size)
    else:
        raise ValueError(f"unknown operator {operator!r}")
    return out[cell[:, 0], cell[:, 1]]


def progressive_morphological_filter(
    cloud: Cloud,
    cell_size: float = 1.0,
    max_window_size: int = 33,
    slope: float = 0.7,
    initial_distance: float = 0.15,
    max_distance: float = 3.0,
    grid: int = 512,
) -> torch.Tensor:
    """Ground mask ``[N]``: openings with windows 3, 5, 9, 17, ... up to
    ``max_window_size``; a point that rises above the opened surface by more
    than the window's threshold (``initial_distance``, then ``slope *
    (w_k - w_{k-1}) * cell_size + initial_distance``, at most
    ``max_distance``) is not ground."""
    raster, cell = _rasterize_min(cloud, cell_size, grid)
    surface = torch.where(torch.isfinite(raster), raster, _BIG)
    ground = cloud.mask
    window, prev_window = 3, None
    while window <= max_window_size:
        opened = _dilate(_erode(surface, window), window)
        thr = initial_distance if prev_window is None else min(
            slope * (window - prev_window) * cell_size + initial_distance, max_distance)
        ground = ground & (cloud.xyz[:, 2] - opened[cell[:, 0], cell[:, 1]] <= thr)
        surface = opened
        prev_window = window
        window = 2 * window - 1
    return ground
