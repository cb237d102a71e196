"""Integral-image normal estimation for organized clouds.

Counterpart of ``pcl_tpu/features/integral_normals.py`` (PCL's
``IntegralImageNormalEstimation``, COVARIANCE_MATRIX and AVERAGE_3D_GRADIENT
modes). The integral images are two cumulative sums, every pixel's window sum
is four gathers, so the whole ``[H, W]`` normal map is a fixed elementwise
pipeline with no neighbour search.

The window moments are differences of float32 integral images of the whole
frame, as in the reference, so accuracy falls as the frame grows (ROADMAP
C25), and ``torch.cumsum`` adds in another order than XLA: the port agrees with
the JAX package on small frames only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pcl_tpu_torch.core import geometry

_EPS = 1e-12


def _integral(img: torch.Tensor) -> torch.Tensor:
    """Zero-padded 2-D integral image: ``I[r, c] = sum of img[:r, :c]``."""
    s = torch.cumsum(torch.cumsum(img, dim=0), dim=1)
    return torch.nn.functional.pad(s, (0, 0) * (img.dim() - 2) + (1, 0, 1, 0))


def _box_sum(I: torch.Tensor, half: int) -> torch.Tensor:
    """Sum over the ``(2 half + 1)^2`` window centred on each pixel, clamped
    at the borders (the window shrinks near edges)."""
    H, W = I.shape[0] - 1, I.shape[1] - 1
    r = torch.arange(H, device=I.device)
    c = torch.arange(W, device=I.device)
    r0, r1 = torch.clamp(r - half, 0, H), torch.clamp(r + half + 1, 0, H)
    c0, c1 = torch.clamp(c - half, 0, W), torch.clamp(c + half + 1, 0, W)
    A = I[r1[:, None], c1[None, :]]
    B = I[r0[:, None], c1[None, :]]
    C = I[r1[:, None], c0[None, :]]
    D = I[r0[:, None], c0[None, :]]
    return A - B - C + D


def integral_image_normals(
    xyz: torch.Tensor,                 # [H, W, 3] organized points
    valid: torch.Tensor,               # [H, W] bool
    *,
    smoothing_size: int = 5,
    viewpoint: Optional[torch.Tensor] = None,
    mode: str = "covariance",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(normals [H,W,3], curvature [H,W])``, normals flipped towards the
    viewpoint and zero where the pixel is invalid or its window holds fewer
    than 3 valid pixels.

    ``mode='covariance'``: the eigenvector of the window covariance's
    smallest eigenvalue. ``mode='gradient'``: the cross product of the
    smoothed horizontal and vertical position gradients (curvature 0)."""
    if mode not in ("covariance", "gradient"):
        raise ValueError(f"unknown mode {mode!r}")
    if viewpoint is None:
        viewpoint = torch.zeros(3, dtype=xyz.dtype, device=xyz.device)
    half = max(1, smoothing_size // 2)
    w = valid.to(xyz.dtype)
    pw = xyz * w[..., None]

    cnt = _box_sum(_integral(w[..., None]), half)[..., 0]    # [H,W]
    s_p = _box_sum(_integral(pw), half)                      # [H,W,3]
    cnt_safe = torch.clamp(cnt, min=1.0)
    mu = s_p / cnt_safe[..., None]

    if mode == "covariance":
        # second moments through integral images of the 6 unique products
        m2 = torch.stack([pw[..., 0] * xyz[..., 0], pw[..., 0] * xyz[..., 1],
                          pw[..., 0] * xyz[..., 2], pw[..., 1] * xyz[..., 1],
                          pw[..., 1] * xyz[..., 2], pw[..., 2] * xyz[..., 2]], dim=-1)
        s2 = _box_sum(_integral(m2), half) / cnt_safe[..., None]
        cov = torch.stack([
            s2[..., 0] - mu[..., 0] * mu[..., 0],
            s2[..., 1] - mu[..., 0] * mu[..., 1],
            s2[..., 2] - mu[..., 0] * mu[..., 2],
            s2[..., 3] - mu[..., 1] * mu[..., 1],
            s2[..., 4] - mu[..., 1] * mu[..., 2],
            s2[..., 5] - mu[..., 2] * mu[..., 2],
        ], dim=-1)
        C = torch.stack([
            torch.stack([cov[..., 0], cov[..., 1], cov[..., 2]], -1),
            torch.stack([cov[..., 1], cov[..., 3], cov[..., 4]], -1),
            torch.stack([cov[..., 2], cov[..., 4], cov[..., 5]], -1),
        ], dim=-2)                                            # [H,W,3,3]
        H_, W_ = C.shape[:2]
        lam, V = geometry.eigh33(C.reshape(-1, 3, 3))
        n = V[:, :, 0].reshape(H_, W_, 3)
        lam = lam.reshape(H_, W_, 3)
        lam_sum = torch.sum(lam, dim=-1)
        curvature = torch.where(lam_sum > 0, lam[..., 0] / torch.clamp(lam_sum, min=_EPS), 0.0)
    else:
        gx = torch.zeros_like(mu)
        gx[:, 1:-1] = 0.5 * (mu[:, 2:] - mu[:, :-2])
        gy = torch.zeros_like(mu)
        gy[1:-1, :] = 0.5 * (mu[2:, :] - mu[:-2, :])
        n = torch.linalg.cross(gx, gy)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=_EPS)
        curvature = torch.zeros(n.shape[:2], dtype=n.dtype, device=n.device)

    flip = torch.sum(n * (viewpoint - xyz), dim=-1) < 0
    n = torch.where(flip[..., None], -n, n)
    ok = valid & (cnt >= 3)
    return torch.where(ok[..., None], n, 0.0), torch.where(ok, curvature, 0.0)
