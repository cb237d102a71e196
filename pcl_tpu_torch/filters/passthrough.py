"""Range, box, predicate and plane filters.

Counterpart of ``pcl_tpu/filters/passthrough.py`` (PCL's PassThrough,
CropBox, the functor filter and the plane clipper). Each is a mask update:
removed points become padding and the capacity is unchanged (PCL's
``keep_organized``); ``core.cloud.compact`` squeezes them out.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.core.transforms import invert_rigid, transform_points

_AXIS = {"x": 0, "y": 1, "z": 2}


def pass_through(cloud: Cloud, field: str, lo: float, hi: float,
                 negative: bool = False) -> Cloud:
    """Keep points whose ``field`` ('x', 'y', 'z' or a scalar attribute) lies
    in ``[lo, hi]``, or outside it with ``negative``."""
    if field in _AXIS:
        v = cloud.xyz[:, _AXIS[field]]
    else:
        v = cloud.attrs[field]
        if v.ndim != 1:
            raise ValueError(f"pass_through needs a scalar field, {field} is {tuple(v.shape)}")
    keep = (v >= lo) & (v <= hi)
    return cloud.with_mask(~keep if negative else keep)


def crop_box(cloud: Cloud, min_pt, max_pt, transform: Optional[torch.Tensor] = None,
             negative: bool = False) -> Cloud:
    """Keep points inside an axis-aligned box, or an oriented one when
    ``transform`` (box frame to world) is given: points are moved into the
    box frame first."""
    pts = cloud.xyz
    if transform is not None:
        pts = transform_points(invert_rigid(transform.to(pts.device, torch.float32)), pts)
    lo = torch.as_tensor(min_pt, dtype=torch.float32).to(pts.device)
    hi = torch.as_tensor(max_pt, dtype=torch.float32).to(pts.device)
    keep = torch.all((pts >= lo) & (pts <= hi), dim=-1)
    return cloud.with_mask(~keep if negative else keep)


def function_filter(cloud: Cloud, fn: Callable[[Cloud], torch.Tensor],
                    negative: bool = False) -> Cloud:
    """Keep points where ``fn(cloud) -> [N] bool`` is True."""
    keep = fn(cloud)
    return cloud.with_mask(~keep if negative else keep)


def clip_plane(cloud: Cloud, plane, negative: bool = False) -> Cloud:
    """Keep points on the positive side of the plane ``[a, b, c, d]``
    (``ax + by + cz + d >= 0``)."""
    p = torch.as_tensor(plane, dtype=torch.float32).to(cloud.xyz.device)
    keep = cloud.xyz @ p[:3] + p[3] >= 0
    return cloud.with_mask(~keep if negative else keep)
