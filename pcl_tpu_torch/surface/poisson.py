"""Poisson surface reconstruction: a spectral solve on a dense grid.

Counterpart of ``pcl_tpu/surface/poisson.py`` (PCL's Poisson, re-designed in
the JAX package on a dense ``[R, R, R]`` grid, ``R = 2^depth``):

1. a trilinear splat of the unit normals into a vector field (eight
   corner scatter-adds, each ``index_put_`` with accumulation, which adds
   duplicates in index order, so the card repeats bitwise: ROADMAP C28);
2. its divergence by central differences;
3. ``chi = ifftn(fftn(div) / eig)`` against the periodic Laplacian's
   eigenvalues (``torch.fft``; it rounds apart from XLA's FFT, C56);
4. the iso value, the mean of ``chi`` at the samples (trilinear);
5. surface nets of ``chi - iso`` on the host, then the data-support trim:
   triangles farther than ``mask_dilation`` cells from every sample are
   dropped, decided by scipy's ``cKDTree`` on the host as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.surface.reconstruction import surface_nets


def _fftfreq32(R: int, device) -> torch.Tensor:
    """``jnp.fft.fftfreq(R)`` in float32."""
    i = torch.arange(R, device=device)
    k = torch.where(i < (R + 1) // 2, i, i - R).to(torch.float32)
    return k / float(R)


def indicator_grid(xyz: torch.Tensor, mask: torch.Tensor, normals: torch.Tensor,
                   grid_min: torch.Tensor, cell: torch.Tensor, resolution: int, alpha: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve for the indicator ``chi`` on an ``[R, R, R]`` grid:
    ``(chi, iso, occupancy [R, R, R] bool)``."""
    R = resolution
    dev = xyz.device
    g = torch.clamp((xyz - grid_min[None, :]) / cell[None, :], 0.0, R - 1.001)
    i0 = xla_int32(torch.floor(g)).to(torch.int64)
    f = g - i0
    w = torch.where(mask, 1.0, 0.0)
    vec = normals * w[:, None]

    field = torch.zeros((R, R, R, 3), dtype=torch.float32, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wt = ((f[:, 0] if dx else 1.0 - f[:, 0]) * (f[:, 1] if dy else 1.0 - f[:, 1])
                      * (f[:, 2] if dz else 1.0 - f[:, 2]))
                ii = torch.clamp(i0 + torch.tensor([dx, dy, dz], device=dev), 0, R - 1)
                add_rows(field, (ii[:, 0], ii[:, 1], ii[:, 2]), vec * wt[:, None])

    def cdiff(a, axis):
        return (torch.roll(a, -1, axis) - torch.roll(a, 1, axis)) * 0.5

    div = (cdiff(field[..., 0], 0) / cell[0] + cdiff(field[..., 1], 1) / cell[1]
           + cdiff(field[..., 2], 2) / cell[2])
    del field

    two_pi = float(np.float32(2.0 * math.pi))              # ``2.0 * jnp.pi`` in float32
    cosk = 2.0 * torch.cos(two_pi * _fftfreq32(R, dev)) - 2.0
    ex, ey, ez = (cosk / (cell[a] ** 2) for a in range(3))
    eig = ex[:, None, None] + ey[None, :, None] + ez[None, None, :]
    eig = eig - float(np.float32(alpha))
    eig = torch.where(torch.abs(eig) < 1e-12, 1.0, eig)      # the zero mode: chi's mean 0
    chi = torch.fft.ifftn(torch.fft.fftn(div) / eig).real
    del div, eig

    def gather(vol):
        i1 = torch.clamp(i0 + 1, 0, R - 1)
        x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
        x1, y1, z1 = i1[:, 0], i1[:, 1], i1[:, 2]
        fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
        c00 = vol[x0, y0, z0] * (1 - fx) + vol[x1, y0, z0] * fx
        c10 = vol[x0, y1, z0] * (1 - fx) + vol[x1, y1, z0] * fx
        c01 = vol[x0, y0, z1] * (1 - fx) + vol[x1, y0, z1] * fx
        c11 = vol[x0, y1, z1] * (1 - fx) + vol[x1, y1, z1] * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return c0 * (1 - fz) + c1 * fz

    iso = torch.sum(torch.where(mask, gather(chi), 0.0)) / torch.clamp(torch.sum(w), min=1.0)
    occ = torch.zeros((R, R, R), dtype=torch.bool, device=dev)
    occ[i0[mask, 0], i0[mask, 1], i0[mask, 2]] = True
    return chi, iso, occ


def poisson_bounds(cloud: Cloud, depth: int, scale: float):
    """``(grid_min, grid_max, cell [3])`` float32 and the cube's half side:
    the valid points' bounding cube, centred, inflated by ``scale``
    (setScale)."""
    R = 1 << depth
    pts = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center = 0.5 * (lo + hi)
    half = 0.5 * float(scale) * float((hi - lo).max() + 1e-9)
    gmin = (center - half).astype(np.float32)
    gmax = (center + half).astype(np.float32)
    return gmin, gmax, ((gmax - gmin) / (R - 1)).astype(np.float32), half


def poisson_reconstruction(cloud: Cloud, depth: int = 5, scale: float = 1.15,
                           screen: float = 0.0, mask_dilation: int = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """A mesh of an oriented cloud: ``(vertices [V, 3] float32, triangles
    [F, 3] int32)``. ``depth`` and ``scale`` are pcl::Poisson's setDepth and
    setScale; ``screen`` adds a uniform far-field damping; ``mask_dilation``
    (cells, default ``R // 10``) bounds how far from any sample the surface
    may reach."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("poisson_reconstruction requires normals")
    R = 1 << depth
    gmin, gmax, cellv, half = poisson_bounds(cloud, depth, scale)
    dev = cloud.xyz.device
    chi, iso, _ = indicator_grid(cloud.xyz, cloud.mask, cloud.attrs[ATTR_NORMAL],
                                 torch.from_numpy(gmin).to(dev), torch.from_numpy(cellv).to(dev),
                                 R, alpha=float(screen) / (2.0 * half) ** 2)
    field = chi.cpu().numpy().astype(np.float64) - float(iso)
    V, F = surface_nets(field.astype(np.float32), gmin, gmax)
    pts = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
    if len(F) and len(pts):
        from scipy.spatial import cKDTree

        k = mask_dilation if mask_dilation is not None else max(2, R // 10)
        vd = cKDTree(pts).query(V)[0]
        keep_f = (vd <= k * float(cellv.max()))[F].all(axis=1)
        F = F[keep_f]
        used = np.unique(F)
        remap = np.full(len(V), -1, np.int64)
        remap[used] = np.arange(len(used))
        V = V[used]
        F = remap[F].astype(np.int32)
    return V, F
