"""Batched 2-D image primitives (PCL's 2d/ convolution.h, edge.h,
morphology.h: pcl::Convolution, pcl::Edge Sobel/Prewitt/Canny,
pcl::Morphology).

Counterpart of ``pcl_tpu/image/ops.py``. The JAX package correlates with
``conv_general_dilated`` (no kernel flip) and takes window minima and maxima
with ``reduce_window``, both with XLA's "SAME" padding, which puts the extra
pad of an even size at the end (low ``(k - 1) // 2``, high ``k - 1 - low``).
Here the pads are explicit: zeros before ``conv2d``, the window's init value
(``-inf`` for a maximum) before ``max_pool2d``; erosion is the negated
dilation. Canny's hysteresis is capped at 64 sweeps, as in the reference, and
reads one flag back per sweep.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from pcl_tpu_torch.core.casts import xla_int32

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_PREWITT_X = ((-1.0, 0.0, 1.0), (-1.0, 0.0, 1.0), (-1.0, 0.0, 1.0))
_HYSTERESIS_SWEEPS = 64


def _same_pads(kh: int, kw: int) -> Tuple[int, int, int, int]:
    """``F.pad`` order (left, right, top, bottom) of XLA's "SAME"."""
    lw, lh = (kw - 1) // 2, (kh - 1) // 2
    return lw, kw - 1 - lw, lh, kh - 1 - lh


def _conv(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``[H, W]`` correlated with ``[kh, kw]``, zero padding, same size."""
    kernel = kernel.to(img.dtype)
    x = F.pad(img[None, None], _same_pads(*kernel.shape))
    return F.conv2d(x, kernel[None, None])[0, 0]


def convolve2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """2-D correlation (pcl::Convolution semantics: same-size output)."""
    return _conv(img.to(torch.float32), torch.as_tensor(kernel, device=img.device)
                 .to(torch.float32))


def gaussian_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    """``[size, size]`` normalised Gaussian."""
    r = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(r ** 2) / (2.0 * sigma * sigma))
    k = torch.outer(g, g)
    return k / torch.sum(k)


def gaussian_blur(img: torch.Tensor, size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    return convolve2d(img, gaussian_kernel(size, sigma, img.device))


def _magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """``sqrt(gx gx + gy gy)``: float32 products and sum, the root correctly
    rounded as XLA's (torch's float32 CPU root is not always, ROADMAP C75)."""
    return torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(torch.float32)


def _gradients(img: torch.Tensor, kx) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    k = torch.tensor(kx, dtype=torch.float32, device=img.device)
    gx, gy = _conv(img, k), _conv(img, k.T)
    return gx, gy, _magnitude(gx, gy)


def sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gx, gy, magnitude)`` by Sobel (edge.h detectEdgeSobel)."""
    return _gradients(img, _SOBEL_X)


def prewitt(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _gradients(img, _PREWITT_X)


def _window_max(img: torch.Tensor, size: int) -> torch.Tensor:
    x = F.pad(img[None, None], _same_pads(size, size), value=-math.inf)
    return F.max_pool2d(x, size, stride=1)[0, 0]


def erode(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Grey-scale erosion (morphology.h erosionGray): the window minimum,
    ``+inf`` beyond the border."""
    return -_window_max(-img, size)


def dilate(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """The window maximum, ``-inf`` beyond the border."""
    return _window_max(img, size)


def canny(img: torch.Tensor, low: float, high: float, size: int = 5,
          sigma: float = 1.4) -> torch.Tensor:
    """Canny edges (edge.h detectEdgeCanny): blur, Sobel, non-maximum
    suppression along the quantised gradient direction, hysteresis."""
    sm = gaussian_blur(img.to(torch.float32), size, sigma)
    gx, gy, _ = sobel(sm)
    return canny_from_gradients(gx, gy, low, high)


def canny_from_gradients(gx: torch.Tensor, gy: torch.Tensor, low: float,
                         high: float) -> torch.Tensor:
    """Canny's suppression and hysteresis over gradient images the caller
    gives (pcl::Edge::canny(input_x, input_y, ...)). The direction is
    quantised to 0/45/90/135 degrees (``round`` ties to even, as
    ``jnp.round``); the neighbours wrap around the image (``jnp.roll``).
    Hysteresis grows the strong set over the weak one by 3 x 3 dilations,
    at most 64 sweeps: an unconverged image is returned as it stands."""
    mag = _magnitude(gx, gy)
    ang = torch.atan2(gy, gx)
    a = xla_int32(torch.remainder(torch.round(ang / (math.pi / 4.0)), 4))

    def shift(m, dy, dx):
        return torch.roll(m, (dy, dx), (0, 1))

    n0 = torch.maximum(shift(mag, 0, 1), shift(mag, 0, -1))
    n1 = torch.maximum(shift(mag, 1, 1), shift(mag, -1, -1))
    n2 = torch.maximum(shift(mag, 1, 0), shift(mag, -1, 0))
    n3 = torch.maximum(shift(mag, 1, -1), shift(mag, -1, 1))
    neigh = torch.where(a == 0, n0, torch.where(a == 1, n1, torch.where(
        a == 2, n2, torch.where(a == 3, n3, torch.zeros_like(mag)))))
    nms = torch.where(mag >= neigh, mag, 0.0)
    s = nms >= high
    weak = nms >= low
    for _ in range(_HYSTERESIS_SWEEPS):
        grown = (dilate(s.to(torch.float32), 3) > 0) & weak
        changed = bool(torch.any(grown != s))
        s = grown
        if not changed:
            break
    return s
