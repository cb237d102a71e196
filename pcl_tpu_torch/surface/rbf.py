"""Marching-cubes RBF reconstruction.

Counterpart of ``pcl_tpu/surface/rbf.py`` (PCL's MarchingCubesRBF): an
implicit function interpolating 0 at each (subsampled) point and ``-+eps``
at ``p +- eps n``, with the triharmonic kernel ``phi(r) = r^3``. The dense
symmetric solve and the grid evaluation run on the cloud's device; the
subsample is drawn on the host with ``np.random.default_rng(seed)``, the
JAX package's own draw (ROADMAP C61); the mesh comes from surface nets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.surface.reconstruction import grid_points, surface_nets

_CHUNK = 1 << 16          # grid points a product at a time


def _phi(r2: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.clamp(r2, min=1e-20), 1.5)


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)


def rbf_field(centers: torch.Tensor, values: torch.Tensor, grid_min: torch.Tensor,
              grid_max: torch.Tensor, resolution: int) -> torch.Tensor:
    """The interpolant on an ``[R, R, R]`` grid: ``(phi(D) + 1e-6 I) w =
    values``, then ``phi(|q - c|^2) w`` at every grid point."""
    A = _phi(_sqdist(centers, centers))
    A = A + 1e-6 * torch.eye(centers.shape[0], device=centers.device)
    w = torch.linalg.solve_ex(A, values[:, None])[0][:, 0]
    q = grid_points(grid_min, grid_max, resolution)
    f = torch.cat([_phi(_sqdist(q[s:s + _CHUNK], centers)) @ w
                   for s in range(0, q.shape[0], _CHUNK)])
    return f.reshape(resolution, resolution, resolution)


def rbf_constraints(cloud: Cloud, off_surface_epsilon: float, max_centers: int, padding: float,
                    seed: int):
    """``(centers [3M, 3], values [3M], grid_min, grid_max)`` on the host:
    ``max_centers`` points drawn without replacement when there are more,
    each with its two off-surface constraints, and the padded bounding box."""
    m = cloud.mask.cpu().numpy()
    pts = cloud.xyz.cpu().numpy()[m]
    nn = cloud.attrs[ATTR_NORMAL].cpu().numpy()[m]
    if len(pts) > max_centers:
        sel = np.random.default_rng(seed).choice(len(pts), max_centers, replace=False)
        pts, nn = pts[sel], nn[sel]
    eps = off_surface_epsilon
    centers = np.concatenate([pts, pts + eps * nn, pts - eps * nn])
    values = np.concatenate([np.zeros(len(pts)), -eps * np.ones(len(pts)),
                             eps * np.ones(len(pts))])
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo + 1e-9
    return (centers.astype(np.float32), values.astype(np.float32),
            (lo - padding * span).astype(np.float32), (hi + padding * span).astype(np.float32))


def marching_cubes_rbf(cloud: Cloud, resolution: int = 32, off_surface_epsilon: float = 0.05,
                       max_centers: int = 300, padding: float = 0.15, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """``(vertices, triangles)``; ``off_surface_epsilon`` is
    setOffSurfaceDisplacement, and at most ``max_centers`` points (three
    constraints each) enter the ``O(M^2)`` system."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("marching_cubes_rbf requires normals")
    centers, values, gmin, gmax = rbf_constraints(cloud, off_surface_epsilon, max_centers,
                                                  padding, seed)
    dev = cloud.xyz.device
    field = rbf_field(*(torch.from_numpy(a).to(dev) for a in (centers, values, gmin, gmax)),
                      resolution)
    return surface_nets(field.cpu().numpy(), gmin, gmax)
