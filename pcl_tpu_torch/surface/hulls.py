"""Convex and concave hulls.

Counterpart of ``pcl_tpu/surface/hulls.py`` (PCL's ConvexHull and
ConcaveHull, both Qhull). Host code in both packages: scipy wraps the same
Qhull library, and the concave hull is the alpha shape over the Delaunay
triangulation, with vectorized circumradii and boundary facets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, to_numpy


def convex_hull(cloud: Cloud, dim: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """``(hull vertices [V, 3], simplices [F, dim] int32)``, the simplices
    indexing the returned vertices."""
    from scipy.spatial import ConvexHull

    xyz, _ = to_numpy(cloud, compact=True)
    hull = ConvexHull(xyz[:, :dim])
    used = np.unique(hull.simplices)
    remap = -np.ones(len(xyz), np.int64)
    remap[used] = np.arange(len(used))
    return xyz[used], remap[hull.simplices].astype(np.int32)


def _circumradius2d(p: np.ndarray) -> np.ndarray:
    """Circumradii of triangles ``p [T, 3, 2]``."""
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    ab = np.linalg.norm(b - a, axis=1)
    bc = np.linalg.norm(c - b, axis=1)
    ca = np.linalg.norm(a - c, axis=1)
    e1, e2 = b - a, c - a
    area2 = np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    return ab * bc * ca / np.maximum(2.0 * area2, 1e-300)


def _circumradius3d(p: np.ndarray) -> np.ndarray:
    """Circumradii of tetrahedra ``p [T, 4, 3]``: solve ``2 A c = |A_i|^2``
    with ``A``'s rows the edges from vertex 0."""
    A = p[:, 1:] - p[:, :1]
    rhs = np.sum(A * A, axis=2)
    ok = np.abs(np.linalg.det(A)) > 1e-300
    r = np.full(len(p), np.inf)
    if ok.any():
        center = np.linalg.solve(2.0 * A[ok], rhs[ok][..., None])[..., 0]
        r[ok] = np.linalg.norm(center, axis=1)
    return r


def concave_hull(cloud: Cloud, alpha: float, dim: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Alpha-shape boundary: in 2-D the boundary edges of the Delaunay
    triangles whose circumradius is at most ``alpha`` (ConcaveHull's
    setAlpha), in 3-D the boundary faces of such tetrahedra."""
    from scipy.spatial import Delaunay

    xyz, _ = to_numpy(cloud, compact=True)
    pts = xyz[:, :dim].astype(np.float64)
    simp = Delaunay(pts).simplices
    p = pts[simp]
    r = _circumradius2d(p) if dim == 2 else _circumradius3d(p)
    kept = simp[r <= alpha]
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, dim), np.int32))
    if len(kept) == 0:
        return empty
    # every facet of every kept simplex; a facet seen once is on the boundary
    drop = np.stack([np.delete(np.arange(dim + 1), d) for d in range(dim + 1)])
    facets = np.sort(kept[:, drop].reshape(len(kept) * (dim + 1), dim), axis=1)
    uniq, counts = np.unique(facets, axis=0, return_counts=True)
    boundary = uniq[counts == 1]
    if len(boundary) == 0:
        return empty
    used = np.unique(boundary)
    remap = -np.ones(len(xyz), np.int64)
    remap[used] = np.arange(len(used))
    return xyz[used], remap[boundary].astype(np.int32)
