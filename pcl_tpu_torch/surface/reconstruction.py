"""Surface reconstruction: implicit-function meshing and organized meshing.

Counterpart of ``pcl_tpu/surface/reconstruction.py`` (PCL's
MarchingCubesHoppe and OrganizedFastMesh).

- ``hoppe_signed_distance``: Hoppe's signed distance to the nearest point's
  tangent plane on a dense ``[R, R, R]`` grid. The grid's ``R^3`` queries go
  to ``search.bruteforce.nn1`` in one call, which is kernel B1 on CUDA
  tensors at every size and its plain version on CPU tensors: both return
  the exactly recomputed distance, where the JAX package's CPU path returns
  the matmul identity's (ROADMAP C1, C55).
- ``surface_nets``: naive surface nets over the SDF grid, host numpy, copied
  from the JAX package so that the same SDF gives the same mesh bit for bit.
- ``organized_fast_mesh``: two triangles per pixel quad of an organized
  cloud, gated by validity and an edge length.

Meshes are ``(vertices [V, 3] float32, triangles [F, 3] int32)`` numpy arrays.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.search import bruteforce


def linspace32(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace``'s formula in float32: ``start (1 - s) + stop s`` with
    ``s = i / (num - 1)``, the last sample ``stop`` exactly. XLA compiles it
    reassociated, so a sample may differ from the JAX package's in its last
    bit (ROADMAP C55)."""
    if num == 1:
        return start.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) / float(div)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def grid_points(grid_min: torch.Tensor, grid_max: torch.Tensor, resolution: int) -> torch.Tensor:
    """The ``R^3`` grid's points ``[R^3, 3]`` in ``ij`` order."""
    lin = [linspace32(grid_min[i], grid_max[i], resolution) for i in range(3)]
    g = torch.meshgrid(*lin, indexing="ij")
    return torch.stack(g, dim=-1).reshape(-1, 3)


def hoppe_signed_distance(cloud: Cloud, grid_min, grid_max, resolution: int = 32) -> torch.Tensor:
    """``[R, R, R]`` signed distance ``n_p . (x - p)`` for the nearest point
    ``p`` of each grid point ``x``: one 1-NN of the ``R^3`` grid against the
    cloud (kernel B1 on the card)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("hoppe_signed_distance requires normals")
    dev = cloud.xyz.device
    lo = torch.as_tensor(grid_min, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(grid_max, dtype=torch.float32, device=dev)
    q = grid_points(lo, hi, resolution)
    idx, _ = bruteforce.nn1(cloud.xyz, cloud.mask, q)
    idx = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    p = cloud.xyz[idx]
    n = cloud.attrs[ATTR_NORMAL][idx]
    d = n * (q - p)
    sd = (d[:, 0] + d[:, 1]) + d[:, 2]
    return sd.reshape(resolution, resolution, resolution)


def surface_nets(sdf: np.ndarray, grid_min: np.ndarray, grid_max: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Naive surface nets over a dense SDF grid (host numpy): one vertex per
    cell whose corners change sign (the mean of its edges' zero crossings),
    two triangles across each sign-changing interior edge.

    Returns ``(vertices [V, 3], triangles [F, 3])``."""
    sdf = np.asarray(sdf)
    R = sdf.shape[0]
    spacing = (np.asarray(grid_max) - np.asarray(grid_min)) / (R - 1)

    c = sdf < 0
    corner_sum = (
        c[:-1, :-1, :-1].astype(np.int32) + c[1:, :-1, :-1] + c[:-1, 1:, :-1]
        + c[:-1, :-1, 1:] + c[1:, 1:, :-1] + c[1:, :-1, 1:] + c[:-1, 1:, 1:]
        + c[1:, 1:, 1:]
    )
    active = (corner_sum > 0) & (corner_sum < 8)
    cell_idx = -np.ones(active.shape, np.int64)
    ai, aj, ak = np.nonzero(active)
    cell_idx[ai, aj, ak] = np.arange(len(ai))

    verts = np.zeros((len(ai), 3), np.float64)
    counts = np.zeros(len(ai), np.int32)
    corner_off = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)])
    edges = [(a, b) for a in range(8) for b in range(a + 1, 8)
             if np.sum(np.abs(corner_off[a] - corner_off[b])) == 1]
    base = np.stack([ai, aj, ak], axis=1)
    for a, b in edges:
        pa = base + corner_off[a]
        pb = base + corner_off[b]
        va = sdf[pa[:, 0], pa[:, 1], pa[:, 2]]
        vb = sdf[pb[:, 0], pb[:, 1], pb[:, 2]]
        cross = (va < 0) != (vb < 0)
        t = np.where(cross, va / np.where(va - vb == 0, 1.0, va - vb), 0.0)
        pt = pa + t[:, None] * (pb - pa)
        verts[cross] += pt[cross]
        counts[cross] += 1
    counts = np.maximum(counts, 1)
    verts = verts / counts[:, None]
    verts_world = np.asarray(grid_min) + verts * spacing

    tris = []
    for axis in range(3):
        other = [a for a in range(3) if a != axis]
        sl = [slice(1, -1)] * 3
        sl[axis] = slice(0, -1)
        pa = sdf[tuple(sl)]
        sl2 = list(sl)
        sl2[axis] = slice(1, None)
        pb = sdf[tuple(sl2)]
        cross = (pa < 0) != (pb < 0)
        e = np.stack(np.nonzero(cross), axis=1)
        e[:, other[0]] += 1
        e[:, other[1]] += 1
        offs = []
        for d0 in (0, 1):
            for d1 in (0, 1):
                o = np.zeros(3, np.int64)
                o[other[0]] = -d0
                o[other[1]] = -d1
                offs.append(o)
        ids = np.stack([cell_idx[(e + o)[:, 0], (e + o)[:, 1], (e + o)[:, 2]] for o in offs],
                       axis=1)             # [E, 4] in the order (0,0), (0,1), (1,0), (1,1)
        ok = (ids >= 0).all(axis=1)
        ids = ids[ok]
        flip = (pb < 0)[cross][ok]         # orientation by the sign's direction
        q00, q01, q10, q11 = ids[:, 0], ids[:, 1], ids[:, 2], ids[:, 3]
        t1 = np.where(flip[:, None], np.stack([q00, q11, q01], 1), np.stack([q00, q01, q11], 1))
        t2 = np.where(flip[:, None], np.stack([q00, q10, q11], 1), np.stack([q00, q11, q10], 1))
        tris.append(t1)
        tris.append(t2)
    triangles = np.concatenate(tris)
    return verts_world.astype(np.float32), triangles.astype(np.int32)


def hoppe_grid_bounds(cloud: Cloud, padding: float) -> Tuple[np.ndarray, np.ndarray]:
    """The grid's corners: the valid points' bounding box grown by
    ``padding`` of its span and 1 mm, in float32 as the JAX package forms
    them."""
    xyz = cloud.xyz.cpu().numpy()
    m = cloud.mask.cpu().numpy()
    lo, hi = xyz[m].min(axis=0), xyz[m].max(axis=0)
    span = hi - lo
    return lo - padding * span - 1e-3, hi + padding * span + 1e-3


def reconstruct_hoppe(cloud: Cloud, resolution: int = 48, padding: float = 0.05
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Cloud with normals -> ``(vertices, triangles)`` by the Hoppe SDF and
    surface nets (MarchingCubesHoppe::reconstruct)."""
    lo, hi = hoppe_grid_bounds(cloud, padding)
    sdf = hoppe_signed_distance(cloud, lo, hi, resolution=resolution).cpu().numpy()
    return surface_nets(sdf, lo, hi)


def organized_fast_mesh_mask(cloud: Cloud, max_edge: float = math.inf) -> torch.Tensor:
    """``[H-1, W-1, 2]`` validity of the two triangles of each pixel quad."""
    H, W = cloud.height, cloud.width
    xyz = cloud.xyz.reshape(H, W, 3)
    msk = cloud.mask.reshape(H, W)
    p00, p01, p10, p11 = xyz[:-1, :-1], xyz[:-1, 1:], xyz[1:, :-1], xyz[1:, 1:]
    m = msk[:-1, :-1] & msk[:-1, 1:] & msk[1:, :-1] & msk[1:, 1:]

    def short(a, b):
        return torch.linalg.vector_norm(a - b, dim=-1) <= max_edge

    t1 = m & short(p00, p01) & short(p01, p11) & short(p11, p00)
    t2 = m & short(p00, p11) & short(p11, p10) & short(p10, p00)
    return torch.stack([t1, t2], dim=-1)


def organized_fast_mesh(cloud: Cloud, max_edge: float = math.inf
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """``(vertices = the organized grid, triangles [F, 3])``
    (OrganizedFastMesh's TRIANGLE_MESH mode)."""
    H, W = cloud.height, cloud.width
    ok = organized_fast_mesh_mask(cloud, max_edge).cpu().numpy()
    verts = cloud.xyz.cpu().numpy()
    idx = np.arange(H * W).reshape(H, W)
    i00, i01, i10, i11 = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    t1 = np.stack([i00, i01, i11], axis=-1)[ok[..., 0]]
    t2 = np.stack([i00, i11, i10], axis=-1)[ok[..., 1]]
    return verts, np.concatenate([t1, t2]).astype(np.int32)
