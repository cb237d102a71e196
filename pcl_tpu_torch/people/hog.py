"""HOG features (PCL's ``people/hog.h``: Dalal and Triggs' histograms of
oriented gradients).

Counterpart of ``pcl_tpu/people/hog.py``: rolled central differences, an
unsigned orientation bin per pixel, one histogram of every cell's magnitudes
added in pixel order (``ops.segsum.add_rows``: ROADMAP C28, C84), and
L2-normalised blocks of ``block_size^2`` cells.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.ops.nn1 import _fma32
from pcl_tpu_torch.ops.segsum import add_rows


def hog_features(img: torch.Tensor, cell_size: int = 8, n_bins: int = 9,
                 block_size: int = 2) -> torch.Tensor:
    """``[(H // cell - block + 1) (W // cell - block + 1), block^2 n_bins]``
    L2-normalised block descriptors of a grey image ``[H, W]``."""
    H, W = img.shape
    gx = torch.roll(img, -1, 1) - torch.roll(img, 1, 1)
    gy = torch.roll(img, -1, 0) - torch.roll(img, 1, 0)
    mag = torch.sqrt(_fma32(gx, gx, gy * gy))              # XLA's fused square sum
    ang = torch.remainder(torch.atan2(gy, gx), math.pi)    # unsigned, [0, pi)
    # XLA divides by the constant pi as a product with its float32 reciprocal (C79)
    b = torch.clamp(xla_int32(ang * float(np.float32(1.0) / np.float32(math.pi)) * n_bins),
                    0, n_bins - 1)
    ch, cw = H // cell_size, W // cell_size
    yy = torch.arange(H, device=img.device) // cell_size
    xx = torch.arange(W, device=img.device) // cell_size
    flat_idx = (yy[:, None] * cw + xx[None, :]) * n_bins + b
    # cells past the last whole one (H, W not multiples of the cell) fall
    # outside the histogram, as segment_sum drops them
    ok = (flat_idx < ch * cw * n_bins).reshape(-1)
    hist = torch.zeros(ch * cw * n_bins + 1, dtype=torch.float32, device=img.device)
    add_rows(hist, torch.where(ok, flat_idx.reshape(-1), ch * cw * n_bins), mag.reshape(-1))
    hist = hist[:-1].reshape(ch, cw, n_bins)
    bh = ch - block_size + 1
    bw = cw - block_size + 1
    blk = torch.cat([hist[dy:dy + bh, dx:dx + bw] for dy in range(block_size)
                     for dx in range(block_size)], dim=-1)
    norm = torch.clamp(torch.linalg.vector_norm(blk, dim=-1, keepdim=True), min=1e-6)
    return (blk / norm).reshape(bh * bw, -1)
