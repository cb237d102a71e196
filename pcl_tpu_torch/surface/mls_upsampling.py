"""MLS projection of arbitrary queries and the reference's upsampling modes.

Counterpart of ``pcl_tpu/surface/mls_upsampling.py`` (PCL's
MovingLeastSquares upsampling: DISTINCT_CLOUD, SAMPLE_LOCAL_PLANE,
RANDOM_UNIFORM_DENSITY, VOXEL_GRID_DILATION).

- ``mls_project``: project any queries onto the MLS surface of a support
  cloud (Gaussian-weighted plane and polynomial per query, batched).
- ``mls_upsample_local_plane``: a disc of samples on each point's plane.
- ``mls_upsample_random_density``: uniform samples in each point's disc,
  drawn on the host with ``np.random.default_rng(seed)``, the JAX package's
  own draws (ROADMAP C61).
- ``mls_upsample_voxel_dilation``: voxel centres of the dilated occupancy.
- ``mls_distinct_cloud``: project a given cloud.

The sample layouts are host numpy in both packages; the projections run on
the support cloud's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud, make_cloud
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.surface.mls import _EPS, poly_coeffs


def mls_project(cloud: Cloud, queries, search_radius: float, k: int = 48,
                polynomial_order: int = 2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project ``[Q, 3]`` queries onto the MLS surface of ``cloud``:
    ``(projected [Q, 3], normals [Q, 3], ok [Q])``; a query with fewer
    neighbours than terms is returned unmoved."""
    xyz, mask = cloud.xyz, cloud.mask
    queries = torch.as_tensor(queries, dtype=torch.float32, device=xyz.device)
    idx, d2, valid, count = bruteforce.radius(xyz, mask, queries, search_radius, cap=k)
    r32 = np.float32(search_radius)
    w = torch.where(valid, torch.exp(-d2 / float(r32 * r32)), 0.0)
    nbr = xyz[torch.clamp(idx.long(), 0, cloud.capacity - 1)]
    wsum = torch.clamp(torch.sum(w, dim=1), min=_EPS)
    mu = torch.einsum("nk,nki->ni", w, nbr) / wsum[:, None]
    dc = nbr - mu[:, None, :]
    cov = torch.einsum("nk,nki,nkj->nij", w, dc, dc) / wsum[:, None, None]
    _, V = geometry.eigh33(cov)
    nrm = V[..., :, 0]
    to_pt = queries - mu
    flip = torch.sum(nrm * to_pt, dim=-1) < 0
    nrm = torch.where(flip[:, None], -nrm, nrm)
    e_u, e_v = V[..., :, 2], V[..., :, 1]
    foot = queries - torch.sum(to_pt * nrm, dim=-1)[:, None] * nrm
    coeffs = poly_coeffs(nbr - foot[:, None, :], w, e_u, e_v, nrm, polynomial_order)
    proj = foot + coeffs[:, 0:1] * nrm
    mn = nrm - coeffs[:, 1:2] * e_u - coeffs[:, 2:3] * e_v
    mn = mn / torch.clamp(torch.linalg.vector_norm(mn, dim=-1, keepdim=True), min=_EPS)
    ok = count >= coeffs.shape[-1]
    return torch.where(ok[:, None], proj, queries), mn, ok


def _projected_cloud(cloud: Cloud, samples: np.ndarray, search_radius: float, kw) -> Cloud:
    proj, nrm, ok = mls_project(cloud, samples, search_radius, **kw)
    out = make_cloud(proj, device=proj.device)
    return out.with_mask(out.mask & ok).with_attrs(normal=nrm)


def mls_distinct_cloud(cloud: Cloud, distinct: Cloud, search_radius: float, **kw) -> Cloud:
    """DISTINCT_CLOUD: ``distinct`` projected onto ``cloud``'s MLS surface
    (setDistinctCloud)."""
    proj, nrm, _ = mls_project(cloud, distinct.xyz, search_radius, **kw)
    out = distinct.with_xyz(torch.where(distinct.mask[:, None], proj, 0.0))
    return out.with_attrs(normal=nrm)


def mls_upsample_local_plane(cloud: Cloud, search_radius: float, upsampling_radius: float,
                             step_size: float, **kw) -> Cloud:
    """SAMPLE_LOCAL_PLANE: a grid of offsets within ``upsampling_radius`` on
    each point's plane (the cloud's normals, else the MLS normals),
    projected."""
    if ATTR_NORMAL not in cloud.attrs:
        _, nrm, _ = mls_project(cloud, cloud.xyz, search_radius, **kw)
    else:
        nrm = cloud.attrs[ATTR_NORMAL]
    steps = np.arange(-upsampling_radius, upsampling_radius + 1e-9, step_size)
    du, dv = np.meshgrid(steps, steps)
    keep = du ** 2 + dv ** 2 <= upsampling_radius ** 2
    offs = np.stack([du[keep], dv[keep]], 1).astype(np.float32)

    n = nrm.cpu().numpy()
    a = np.where(np.abs(n[:, 2:3]) < 0.9, [0.0, 0, 1], [1.0, 0, 0])
    eu = np.cross(a, n)
    eu /= np.linalg.norm(eu, axis=1, keepdims=True) + 1e-12
    ev = np.cross(n, eu)
    base = cloud.xyz.cpu().numpy()
    mask = cloud.mask.cpu().numpy()
    samples = (base[:, None, :] + offs[None, :, 0:1] * eu[:, None, :]
               + offs[None, :, 1:2] * ev[:, None, :]).reshape(-1, 3)
    return _projected_cloud(cloud, samples[np.repeat(mask, len(offs))], search_radius, kw)


def mls_upsample_random_density(cloud: Cloud, search_radius: float, upsampling_radius: float,
                                density: float, seed: int = 0, **kw) -> Cloud:
    """RANDOM_UNIFORM_DENSITY: per valid point ``max(1, round(density pi
    r^2))`` offsets uniform in a disc of radius ``upsampling_radius`` in the
    xy plane, drawn by ``np.random.default_rng(seed)`` as the JAX package
    draws them, projected onto the surface."""
    rng = np.random.default_rng(seed)
    per_pt = max(1, int(round(density * np.pi * upsampling_radius ** 2)))
    base = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
    r = upsampling_radius * np.sqrt(rng.uniform(size=(len(base), per_pt)))
    th = rng.uniform(0, 2 * np.pi, (len(base), per_pt))
    offs = np.stack([r * np.cos(th), r * np.sin(th), np.zeros_like(r)], -1).astype(np.float32)
    return _projected_cloud(cloud, (base[:, None, :] + offs).reshape(-1, 3), search_radius, kw)


def mls_upsample_voxel_dilation(cloud: Cloud, search_radius: float, voxel_size: float,
                                dilation_iterations: int = 1, **kw) -> Cloud:
    """VOXEL_GRID_DILATION: the occupancy grid dilated ``dilation_iterations``
    times, every occupied voxel's centre projected
    (setDilationVoxelSize / setDilationIterations)."""
    pts = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
    lo = pts.min(0) - voxel_size
    key = np.floor((pts - lo) / voxel_size).astype(np.int64)
    occ = np.zeros(key.max(0) + 3, bool)
    occ[key[:, 0] + 1, key[:, 1] + 1, key[:, 2] + 1] = True
    for _ in range(dilation_iterations):
        grown = occ.copy()
        for ax in range(3):
            grown |= np.roll(occ, 1, ax) | np.roll(occ, -1, ax)
        occ = grown
    centers = (np.argwhere(occ).astype(np.float32) - 0.5) * voxel_size + lo
    return _projected_cloud(cloud, centers, search_radius, kw)
