"""SHOT descriptors: so far only the colour conversion that ``gicp6d`` needs.

Counterpart of ``pcl_tpu/features/shot.py`` ``_rgb_to_lab``; the descriptors
themselves (``estimate_shot``, ``estimate_shot_color``) are not ported yet
(ROADMAP.md, queue A, item 19).
"""

from __future__ import annotations

import torch


def _rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> CIELab (D65), ``[..., 3] -> [..., 3]``."""
    c = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    M = torch.tensor([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]], dtype=torch.float32, device=rgb.device)
    white = torch.tensor([0.95047, 1.0, 1.08883], dtype=torch.float32, device=rgb.device)
    t = (c @ M.T) / white
    # a float64 cube root rounded once to float32 (torch has no cbrt)
    cbrt = (torch.clamp(t, min=0.0).double() ** (1.0 / 3.0)).to(torch.float32)
    f = torch.where(t > 0.008856, cbrt, 7.787 * t + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)
