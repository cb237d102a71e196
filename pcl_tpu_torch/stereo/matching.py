"""Stereo block matching + point-cloud reprojection.

Re-design of pcl::GrayStereoMatching / pcl::BlockBasedStereoMatching
(reference: stereo/include/pcl/stereo/stereo_matching.h:110,371,428).
Counterpart of ``pcl_tpu/stereo/matching.py``: one ``[D, H, W]`` SAD cost
volume (box sums with zero padding per disparity), winner-take-all argmin
(the first disparity of a tie), the optional ratio filter and the
left-right consistency check; disparity -> organized cloud by the pinhole
model (``u0 = W / 2`` by default, as the JAX package has it).

The box sum adds the window's 49 (``(2 r + 1)^2``) terms in row-major order
and scales by the float32 reciprocal of its size, as XLA forms the JAX
module's ``reduce_window`` and its division by a constant (ROADMAP C79); two
disparities whose costs lie within rounding of each other may still take
different argmins on the two packages (ROADMAP C88).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud, make_cloud


def _box_mean(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over the ``(2 r + 1)^2`` window about each pixel of ``[..., H,
    W]``, zeros beyond the edges (``reduce_window`` SAME, then ``/ size^2``)."""
    size = 2 * radius + 1
    H, W = img.shape[-2:]
    pad = torch.nn.functional.pad(img, (radius, radius, radius, radius))
    s = torch.zeros_like(img)
    for dy in range(size):
        for dx in range(size):
            s = s + pad[..., dy:dy + H, dx:dx + W]
    return s * float(np.float32(1.0) / np.float32(size * size))


def _shift_cols(img: torch.Tensor, d: int) -> torch.Tensor:
    """``jnp.roll(img, d, axis=1)`` of ``[H, W]``."""
    return torch.roll(img, d, 1)


def block_costs(left: torch.Tensor, right: torch.Tensor, max_disparity: int,
                window_radius: int, right_view: bool = False) -> torch.Tensor:
    """``[D, H, W]`` SAD costs of the left view against the right shifted by
    each disparity (``right_view``: the right against the left shifted the
    other way); columns with no counterpart cost ``inf``."""
    H, W = left.shape
    a, b = (right, left) if right_view else (left, right)
    d = torch.arange(max_disparity, device=left.device)[:, None, None]
    cols = torch.arange(W, device=left.device)[None, None, :]
    shifted = torch.stack([_shift_cols(b, -k if right_view else k)
                           for k in range(max_disparity)])
    valid = cols < (W - d) if right_view else cols >= d
    return torch.where(valid, _box_mean((a - shifted).abs(), window_radius), torch.inf)


def block_matching(
    left: torch.Tensor,         # [H,W] grayscale
    right: torch.Tensor,        # [H,W]
    max_disparity: int = 64,
    window_radius: int = 3,
    lr_check: bool = True,
    lr_tolerance: int = 1,
    ratio_filter: float = 0.0,
) -> torch.Tensor:
    """Disparity map [H,W] f32; invalid pixels = -1 (the reference's
    convention for unmatched). A ``ratio_filter`` above 0 also drops pixels
    whose best cost is not below ``1 - ratio_filter`` times the second
    best (the JAX package's jitted function raises when the argument is
    passed at all, ROADMAP C88)."""
    H, W = left.shape
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    costs = block_costs(left, right, max_disparity, window_radius)
    best = costs.min(0).values
    disp_l = torch.argmin(costs, 0)
    invalid = ~torch.isfinite(best)
    if ratio_filter > 0:
        second = torch.topk(costs, 2, dim=0, largest=False).values[1]
        keep = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(ratio_filter,
                                                                     dtype=torch.float32)
        invalid = invalid | (best > keep.to(left.device) * second)
    if lr_check:
        disp_r = torch.argmin(block_costs(left, right, max_disparity, window_radius,
                                          right_view=True), 0)
        col = torch.arange(W, device=left.device)[None, :].expand(H, W)
        rcol = torch.clamp(col - disp_l, 0, W - 1)
        dr = torch.gather(disp_r, 1, rcol)
        invalid = invalid | ((disp_l - dr).abs() > lr_tolerance)
    return torch.where(invalid, -1.0, disp_l.to(torch.float32))


def disparity_to_cloud(
    disparity: torch.Tensor,    # [H,W], invalid < 0
    focal: float,
    baseline: float,
    u0: Optional[float] = None,
    v0: Optional[float] = None,
) -> Cloud:
    """Organized cloud from disparity (reference
    StereoMatching::getPointCloud): z = f*b/d, x = (u-u0) z / f."""
    H, W = disparity.shape
    dev = disparity.device
    if u0 is None:
        u0 = W / 2.0
    if v0 is None:
        v0 = H / 2.0
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    focal_t = f32(focal)
    v, u = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                          indexing="ij")
    valid = disparity > 0
    z = torch.where(valid, focal_t * f32(baseline) / torch.clamp(disparity, min=1e-6), 0.0)
    x = (u.to(torch.float32) - f32(u0)) * z / focal_t
    y = (v.to(torch.float32) - f32(v0)) * z / focal_t
    xyz = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    return make_cloud(xyz, valid.reshape(-1), width=W, height=H, device=dev)
