"""Point-cloud triangulation: greedy projection fans and polygon ear clipping.

Counterpart of ``pcl_tpu/surface/triangulation.py``.

- ``greedy_projection_triangulation`` (PCL's GreedyProjectionTriangulation,
  re-designed in the JAX package as per-point tangent fans): every point's
  ``k`` nearest neighbours, gated as gp3 gates them (edge length at most
  ``min(mu d_1nn, search_radius)``, normals within ``eps_angle``), are
  projected onto its tangent plane and ordered by angle with one stable sort
  (``jnp.argsort`` is stable); consecutive neighbours whose angular gap lies
  in ``[min_angle, max_angle]`` form a triangle. Duplicates from the up to
  three fans that own a triangle are dropped on the host.
- ``ear_clipping`` / ``triangulate_mesh_polygons`` (PCL's EarClipping): host
  numpy in both packages.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.features.shot import _f32
from pcl_tpu_torch.search import bruteforce


def _fan_candidates(xyz: torch.Tensor, mask: torch.Tensor, normals: torch.Tensor, k: int,
                    mu: float, search_radius: float, min_angle: float, max_angle: float,
                    eps_angle: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point tangent fans: ``(triangles [N, k, 3] int64, valid [N, k])``."""
    n_pts = xyz.shape[0]
    dev = xyz.device
    idx, d2, _ = bruteforce.knn(xyz, mask, xyz, k + 1)       # the point itself first
    idx, d2 = idx[:, 1:].long(), d2[:, 1:]
    idxc = torch.clamp(idx, 0, n_pts - 1)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    nn_valid = mask[idxc] & mask[:, None] & (d2 < 1e29)

    # gp3's distance gate and normal consistency
    d1 = torch.where(nn_valid[:, 0], d[:, 0], math.inf)
    max_edge = torch.minimum(_f32(mu) * d1, torch.tensor(_f32(search_radius), device=dev))
    nn_valid = nn_valid & (d <= max_edge[:, None])
    cos_eps = torch.cos(torch.tensor(_f32(eps_angle), device=dev))
    nn_valid = nn_valid & (torch.abs(torch.sum(normals[idxc] * normals[:, None, :], dim=-1))
                           >= cos_eps)

    # the tangent plane's frame
    n = normals
    a = torch.where(torch.abs(n[:, 2:3]) < 0.9,
                    torch.tensor([0.0, 0.0, 1.0], device=dev)[None, :],
                    torch.tensor([1.0, 0.0, 0.0], device=dev)[None, :])
    u = torch.linalg.cross(a, n)
    u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-12)
    v = torch.linalg.cross(n, u)
    rel = xyz[idxc] - xyz[:, None, :]
    theta = torch.atan2(torch.sum(rel * v[:, None, :], dim=-1),
                        torch.sum(rel * u[:, None, :], dim=-1))
    theta = torch.where(nn_valid, theta, math.inf)           # invalid ones sort last

    theta_s, order = torch.sort(theta, dim=1, stable=True)
    idx_s = torch.gather(idx, 1, order)
    valid_s = torch.gather(nn_valid, 1, order)
    cnt = valid_s.sum(dim=1)

    # consecutive pairs around the fan; the last valid one pairs with the first
    col = torch.arange(k, device=dev)[None, :]
    last = col == (cnt - 1)[:, None]
    two_pi = _f32(2.0 * math.pi)
    gap = torch.where(last, two_pi - (theta_s - theta_s[:, 0:1]),
                      torch.roll(theta_s, -1, dims=1) - theta_s)
    nxt = torch.where(last, idx_s[:, 0:1].expand(-1, k), torch.roll(idx_s, -1, dims=1))
    pair_valid = valid_s & (col < cnt[:, None]) & (cnt[:, None] >= 2)
    pair_valid = pair_valid & (gap <= _f32(max_angle)) & (gap >= _f32(min_angle))
    own = torch.arange(n_pts, device=dev)[:, None].expand(n_pts, k)
    return torch.stack([own, idx_s, nxt], dim=-1), pair_valid


def greedy_projection_triangulation(
    cloud: Cloud,
    search_radius: float,
    mu: float = 2.5,
    k: int = 16,
    min_angle: float = np.pi / 18.0,
    max_angle: float = 2.0 * np.pi / 3.0,
    eps_angle: float = np.pi / 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulate an oriented cloud: ``(vertices [V, 3], triangles [F, 3]
    int32)``, indices into the compacted cloud. The parameters are gp3's
    setSearchRadius, setMu, setMaximumNearestNeighbors (``k``),
    setMinimumAngle / setMaximumAngle and setNormalConsistency
    (``eps_angle``)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("greedy_projection_triangulation requires normals")
    tri, ok = _fan_candidates(cloud.xyz, cloud.mask, cloud.attrs[ATTR_NORMAL], k, mu,
                              search_radius, min_angle, max_angle, eps_angle)
    tri = tri.reshape(-1, 3)[ok.reshape(-1)].cpu().numpy()
    tri = tri[(tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2]) & (tri[:, 0] != tri[:, 2])]
    _, uniq = np.unique(np.sort(tri, axis=1), axis=0, return_index=True)
    tri = tri[np.sort(uniq)]

    mask_np = cloud.mask.cpu().numpy()
    keep = np.flatnonzero(mask_np)
    remap = -np.ones(mask_np.shape[0], np.int64)
    remap[keep] = np.arange(keep.size)
    tri = remap[tri]
    tri = tri[(tri >= 0).all(axis=1)]
    return cloud.xyz.cpu().numpy()[keep].astype(np.float32), tri.astype(np.int32)


def _poly_area2(pts2: np.ndarray) -> float:
    x, y = pts2[:, 0], pts2[:, 1]
    return float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def ear_clipping(vertices: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Triangulate one simple polygon (indices into ``vertices``) by ear
    clipping in its best-fit plane: ``[F, 3]`` int32 (EarClipping's
    triangulate / isEar). A polygon that is not simple ends in a fan."""
    poly = np.asarray(polygon, np.int64).copy()
    pts = np.asarray(vertices, np.float64)[poly]
    c = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - c, full_matrices=False)
    uv = (pts - c) @ vt[:2].T
    if _poly_area2(uv) < 0:                                  # counter-clockwise
        poly = poly[::-1]
        uv = uv[::-1]

    tris = []
    active = list(range(len(poly)))
    guard = 0
    while len(active) > 3 and guard < 10 * len(poly):
        guard += 1
        n_a = len(active)
        clipped = False
        for j in range(n_a):
            i0, i1, i2 = active[(j - 1) % n_a], active[j], active[(j + 1) % n_a]
            a, b, c2 = uv[i0], uv[i1], uv[i2]
            cross = (b[0] - a[0]) * (c2[1] - a[1]) - (b[1] - a[1]) * (c2[0] - a[0])
            if cross <= 1e-15:
                continue                                     # reflex or degenerate
            others = [t for t in active if t not in (i0, i1, i2)]
            if others:
                p = uv[others]
                d0 = (b[0] - a[0]) * (p[:, 1] - a[1]) - (b[1] - a[1]) * (p[:, 0] - a[0])
                d1 = (c2[0] - b[0]) * (p[:, 1] - b[1]) - (c2[1] - b[1]) * (p[:, 0] - b[0])
                d2 = (a[0] - c2[0]) * (p[:, 1] - c2[1]) - (a[1] - c2[1]) * (p[:, 0] - c2[0])
                if bool(((d0 >= 0) & (d1 >= 0) & (d2 >= 0)).any()):
                    continue
            tris.append((poly[i0], poly[i1], poly[i2]))
            active.pop(j)
            clipped = True
            break
        if not clipped:
            break
    if len(active) == 3:
        tris.append((poly[active[0]], poly[active[1]], poly[active[2]]))
    elif len(active) > 3:
        for j in range(1, len(active) - 1):
            tris.append((poly[active[0]], poly[active[j]], poly[active[j + 1]]))
    return np.asarray(tris, np.int32).reshape(-1, 3)


def triangulate_mesh_polygons(vertices: np.ndarray, polygons: list) -> np.ndarray:
    """Ear-clip every polygon of a mesh into one ``[F, 3]`` array."""
    out = [ear_clipping(vertices, p) for p in polygons if len(p) >= 3]
    if not out:
        return np.zeros((0, 3), np.int32)
    return np.concatenate(out, axis=0)
