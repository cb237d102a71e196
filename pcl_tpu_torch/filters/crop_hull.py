"""CropHull, ConditionalRemoval and the organized median filter.

Counterpart of ``pcl_tpu/filters/crop_hull.py``:

- ``crop_hull``: keep the points inside (or outside) a closed triangle mesh,
  by the parity of the crossings of a +x ray (Moller-Trumbore against every
  triangle), in chunks of points so that ``[chunk, F, 3]`` stays bounded;
- ``conditional_removal`` with the predicate builders ``field``, ``gt``,
  ``lt``, ``ge``, ``le``, ``and_``, ``or_``, ``not_``;
- ``median_filter``: the window median of an organized cloud's z (PCL
  filters z only), bounded by ``max_movement``; an even count of valid
  neighbours averages the two middle values, as ``jnp.nanmedian`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.sac.ransac import nanmedian

# points a chunk of the crossing test: [chunk, F, 3] float32 temporaries
_HULL_ELEMS = 1 << 24


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _ray_crossings(pts: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """``[N, 3] x [F, 3, 3] -> [N]`` crossings of the +x ray from each
    point (batched Moller-Trumbore)."""
    d = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=pts.device)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    parts = []
    step = max(1, _HULL_ELEMS // max(1, tri.shape[0]))
    for s in range(0, pts.shape[0], step):
        tvec = pts[s:s + step, None, :] - v0[None]
        u = _dot(tvec, pvec[None]) * inv_det
        qvec = _cross(tvec, e1[None])
        v = qvec[..., 0] * inv_det
        t = _dot(qvec, e2[None]) * inv_det
        hit = (torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-9)
        parts.append(torch.sum(hit, dim=1))
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=pts.device)


def crop_hull(cloud: Cloud, hull_vertices, hull_triangles, negative: bool = False) -> Cloud:
    """Keep the points inside the closed hull (an odd number of
    crossings), or outside it with ``negative``."""
    tri = np.asarray(hull_vertices, np.float32)[np.asarray(hull_triangles)]
    crossings = _ray_crossings(cloud.xyz, torch.from_numpy(tri).to(cloud.xyz.device))
    return cloud.with_mask(((crossings % 2) == 1) ^ negative)


def field(name: str):
    """A field accessor: 'x', 'y', 'z' or an attribute name."""
    axis = {"x": 0, "y": 1, "z": 2}.get(name)

    def get(cloud: Cloud) -> torch.Tensor:
        return cloud.xyz[:, axis] if axis is not None else cloud.attrs[name]

    return get


def gt(get, v):
    return lambda c: get(c) > v


def lt(get, v):
    return lambda c: get(c) < v


def ge(get, v):
    return lambda c: get(c) >= v


def le(get, v):
    return lambda c: get(c) <= v


def and_(*preds):
    def f(c):
        m = preds[0](c)
        for p in preds[1:]:
            m = m & p(c)
        return m
    return f


def or_(*preds):
    def f(c):
        m = preds[0](c)
        for p in preds[1:]:
            m = m | p(c)
        return m
    return f


def not_(pred):
    return lambda c: ~pred(c)


def conditional_removal(cloud: Cloud, condition, keep_organized: bool = True) -> Cloud:
    """Keep the points that satisfy the condition tree."""
    return cloud.with_mask(condition(cloud))


def median_filter(cloud: Cloud, window: int = 5, max_movement: float = math.inf) -> Cloud:
    """Median-filter z over the organized grid: each valid pixel moves to
    its window's median of valid z (the frame wraps at its edges), by at most
    ``max_movement``."""
    H, W = cloud.height, cloud.width
    if H <= 1:
        raise ValueError("median_filter requires an organized cloud")
    z = cloud.xyz[:, 2].reshape(H, W)
    m = cloud.mask.reshape(H, W)
    r = window // 2
    stack = torch.stack([
        torch.where(torch.roll(m, (dy, dx), (0, 1)), torch.roll(z, (dy, dx), (0, 1)), math.nan)
        for dy in range(-r, r + 1) for dx in range(-r, r + 1)], dim=-1)
    med = nanmedian(stack, dim=-1)
    med = torch.where(torch.isfinite(med), med, z)
    dz = torch.clamp(med - z, -max_movement, max_movement)
    xyz = cloud.xyz.clone()
    xyz[:, 2] = torch.where(m, z + dz, z).reshape(-1)
    return cloud.with_xyz(torch.where(cloud.mask[:, None], xyz, 0.0))
