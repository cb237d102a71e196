"""Surface post-processing: grid projection, surfel smoothing, bilateral
upsampling, texture mapping.

Counterpart of ``pcl_tpu/surface/processing.py``.

- ``grid_projection`` (PCL's GridProjection, re-designed in the JAX package):
  the Hoppe signed distance on a dense grid (kernel B1 on the card), then on
  the host the cells within one cell diagonal of the surface, each moved
  one Newton step along the finite-difference gradient.
- ``surfel_smoothing`` (PCL's SurfelSmoothing): Gaussian-weighted averages
  of positions and normals over the ``k`` nearest within ``radius``,
  repeated until the largest motion is at most ``converge_eps``; the JAX
  package loops in ``lax.while_loop``, here the host reads back one flag a
  sweep (ROADMAP C48).
- ``bilateral_upsampling`` (PCL's BilateralUpsampling): a joint bilateral
  filter of an organized depth image guided by its colours, shifted-image
  ops.
- ``texture_mapping`` (PCL's TextureMapping): per-vertex UVs from one
  camera, host numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.features.shot import _f32
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.surface.reconstruction import hoppe_signed_distance


def grid_projection(cloud: Cloud, resolution: int = 24, padding: float = 0.1) -> np.ndarray:
    """Near-surface grid cells projected onto the Hoppe zero set: ``[M, 3]``
    surface samples (the reference meshes exactly these points)."""
    xyz = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    span = hi - lo
    gmin = (lo - padding * span).astype(np.float32)
    gmax = (hi + padding * span).astype(np.float32)
    sd = hoppe_signed_distance(cloud, gmin, gmax, resolution=resolution).cpu().numpy()
    cell = (gmax - gmin) / (resolution - 1)
    ii = np.argwhere(np.abs(sd) <= float(np.linalg.norm(cell)))
    if ii.size == 0:
        return np.zeros((0, 3), np.float32)
    centers = gmin[None, :] + ii.astype(np.float32) * cell[None, :]
    g = np.stack(np.gradient(sd, cell[0], cell[1], cell[2]), axis=-1)
    grad = g[ii[:, 0], ii[:, 1], ii[:, 2]]
    gn = np.linalg.norm(grad, axis=1, keepdims=True) + 1e-12
    d = sd[ii[:, 0], ii[:, 1], ii[:, 2]][:, None]
    return (centers - d * grad / gn).astype(np.float32)


def surfel_smoothing(cloud: Cloud, radius: float, k: int = 16, max_iterations: int = 10,
                     converge_eps: float = 1e-5) -> Cloud:
    """Smooth positions and normals iteratively (SurfelSmoothing's
    smoothCloudIteration until the motion stalls)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("surfel_smoothing requires normals")
    mask = cloud.mask
    n_pts = cloud.capacity
    r32 = np.float32(radius)
    r2 = float(r32 * r32)
    two_sigma2 = float(np.float32(2.0) * (r32 * np.float32(0.5)) ** 2)
    eps = float(np.float32(converge_eps))
    p, n = cloud.xyz, cloud.attrs[ATTR_NORMAL]
    for _ in range(max_iterations):
        idx, d2, _ = bruteforce.knn(p, mask, p, k)
        idxc = torch.clamp(idx.long(), 0, n_pts - 1)
        valid = mask[idxc] & (d2 <= r2)
        w = torch.where(valid, torch.exp(-d2 / two_sigma2), 0.0)
        wsum = w.sum(dim=1, keepdim=True) + 1e-12
        new_p = (w[..., None] * p[idxc]).sum(dim=1) / wsum
        new_n = (w[..., None] * n[idxc]).sum(dim=1)
        new_n = new_n / (torch.linalg.vector_norm(new_n, dim=-1, keepdim=True) + 1e-12)
        new_p = torch.where(mask[:, None], new_p, p)
        new_n = torch.where(mask[:, None], new_n, n)
        delta = torch.amax(torch.where(mask, torch.linalg.vector_norm(new_p - p, dim=-1), 0.0))
        p, n = new_p, new_n
        if not bool(delta > eps):
            break
    return cloud.with_xyz(p).with_attrs(**{ATTR_NORMAL: n})


def bilateral_upsampling(depth: torch.Tensor, rgb: torch.Tensor, window: int = 5,
                         sigma_color: float = 15.0, sigma_depth: float = 0.5) -> torch.Tensor:
    """Holes (``<= 0`` or NaN) of an organized depth image ``[H, W]`` filled,
    and valid pixels smoothed, by a joint bilateral filter over a ``window``
    square guided by ``rgb [H, W, 3]`` (wrapping at the image's edges, as the
    JAX package's rolls do)."""
    d = torch.where(torch.isfinite(depth) & (depth > 0), depth, 0.0)
    valid = d > 0
    r = window // 2
    num = torch.zeros_like(d)
    den = torch.zeros_like(d)
    c = rgb.to(torch.float32)
    two_sc2 = float(np.float32(2.0) * np.float32(sigma_color) ** 2)
    two_sd2 = float(np.float32(2.0) * np.float32(sigma_depth) ** 2)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            sd = torch.roll(d, (dy, dx), (0, 1))
            sv = torch.roll(valid, (dy, dx), (0, 1))
            sc = torch.roll(c, (dy, dx), (0, 1))
            w_s = torch.exp(torch.tensor(_f32(-(dx * dx + dy * dy) / (2.0 * (r + 0.5) ** 2))))
            w_s = w_s.item()
            w_c = torch.exp(-torch.sum((sc - c) ** 2, dim=-1) / two_sc2)
            w_d = torch.where(valid, torch.exp(-((sd - d) ** 2) / two_sd2), 1.0)
            w = w_s * w_c * w_d * sv
            num = num + w * sd
            den = den + w
    return torch.where(den > 1e-12, num / den, 0.0)


def texture_mapping(vertices: np.ndarray, triangles: np.ndarray, cam_pose: np.ndarray,
                    fx: float, fy: float, cx: float, cy: float, width: int, height: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vertex UVs from one camera (camera-to-world ``cam_pose``) and
    each triangle's visibility, all three vertices in front of the camera
    and inside the image (mapTexture2Face / getPointUVCoordinates):
    ``(uv [V, 2] float32, visible [F] bool)``."""
    Tcw = np.linalg.inv(np.asarray(cam_pose, np.float64))
    vh = np.concatenate([vertices, np.ones((len(vertices), 1))], axis=1)
    pc = (Tcw @ vh.T).T[:, :3]
    z = pc[:, 2]
    u = fx * pc[:, 0] / np.where(z > 1e-9, z, np.inf) + cx
    v = fy * pc[:, 1] / np.where(z > 1e-9, z, np.inf) + cy
    uv = np.stack([u / width, 1.0 - v / height], axis=1).astype(np.float32)
    in_img = (z > 1e-9) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return uv, in_img[triangles].all(axis=1)
