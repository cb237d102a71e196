"""Depth rendering + observation likelihood.

Re-design of pcl::simulation::RangeLikelihood (reference: simulation/
include/pcl/simulation/range_likelihood.h — OpenGL render of the model at
candidate poses, then per-pixel likelihood of the observed depth).
Counterpart of ``pcl_tpu/simulation/range_likelihood.py``: the model cloud
is splatted through the pinhole model into a z-buffer (``scatter_reduce``
with ``amin``, the JAX module's ``segment_min``: order-free, so exact), and
the per-pixel likelihood is the reference's Gaussian + uniform-outlier
mixture. Pixel coordinates round half to even and cast as XLA casts
(``core.casts.xla_int32``); a point within rounding of a half pixel may
land in the neighbouring pixel on the other package (ROADMAP C92).
"""

from __future__ import annotations

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.fusion.tsdf import Intrinsics


def render_depth(
    cloud: Cloud,
    pose: torch.Tensor,       # [4,4] camera-to-world
    intr: Intrinsics,
    height: int,
    width: int,
) -> torch.Tensor:
    """[H,W] z-buffer depth of the cloud from the pose (0 = empty)."""
    w2c = torch.linalg.inv(pose.to(torch.float32))
    p = cloud.xyz @ w2c[:3, :3].T + w2c[:3, 3]
    z = p[:, 2]
    zc = torch.clamp(z, min=1e-9)
    u = xla_int32(torch.round(intr.fx * p[:, 0] / zc + intr.cx))
    v = xla_int32(torch.round(intr.fy * p[:, 1] / zc + intr.cy))
    ok = cloud.mask & (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    flat = torch.where(ok, v.long() * width + u.long(), width * height)
    img = torch.full((width * height + 1,), torch.inf, dtype=torch.float32, device=z.device)
    img = img.scatter_reduce(0, flat, torch.where(ok, z, torch.inf), "amin")[:-1]
    return torch.where(torch.isfinite(img), img, 0.0).reshape(height, width)


def _recip32(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def range_likelihood(
    rendered: torch.Tensor,   # [H,W] depth of the hypothesis
    observed: torch.Tensor,   # [H,W] measured depth (0/neg = invalid)
    sigma: float = 0.05,
    outlier_prob: float = 0.1,
    max_range: float = 5.0,
) -> torch.Tensor:
    """Scalar log-likelihood (reference range_likelihood.h per-pixel
    Gaussian-plus-floor cost model). The divisions by ``sigma`` and by the
    Gaussian's norm are products with float32 reciprocals, as XLA forms the
    JAX function's divisions by its default constants (ROADMAP C79)."""
    both = (rendered > 0) & (observed > 0)
    d = rendered - observed
    t = d * _recip32(sigma)
    gauss = torch.exp(-0.5 * (t * t)) * _recip32(sigma * 2.5066283)
    mix = (1.0 - outlier_prob) * gauss + outlier_prob / max_range
    ll = torch.where(both, torch.log(torch.clamp(mix, min=1e-12)), 0.0)
    return torch.sum(ll)
