"""Mesh post-processing: the vtk_smoothing family in array form.

Counterpart of ``pcl_tpu/surface/mesh_smoothing.py``, which is host numpy;
the port keeps its own copy (ROADMAP C62), so the same mesh gives the same
result bit for bit (the smoothers find the edge list once, not once a step):

- ``laplacian_smooth`` (MeshSmoothingLaplacianVTK): uniform umbrella steps;
- ``taubin_smooth`` (MeshSmoothingWindowedSincVTK): Taubin's lambda|mu steps;
- ``subdivide_linear`` (MeshSubdivisionVTK, linear): 1 -> 4 triangles;
- ``decimate_cluster`` (the stand-in for MeshQuadricDecimationVTK): vertices
  snapped to their grid cell's centroid;
- ``boundary_vertices``: the vertices of edges used by one triangle.

Meshes are ``(vertices [V, 3], triangles [F, 3] int)`` arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _edge_pairs(triangles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each undirected edge once per direction: ``(src, dst)``, in the JAX
    package's order."""
    e = np.concatenate([triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]])
    e_uniq = np.unique(np.sort(e, axis=1), axis=0)
    return (np.concatenate([e_uniq[:, 0], e_uniq[:, 1]]),
            np.concatenate([e_uniq[:, 1], e_uniq[:, 0]]))


def _umbrella(v: np.ndarray, src: np.ndarray, dst: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Each vertex's step to the mean of its neighbours (0 without any).
    The edge list is the mesh's, found once per call rather than once per
    step; the sums are the JAX package's, bit for bit."""
    sums = np.zeros((len(v), 3), v.dtype)
    np.add.at(sums, src, v[dst])
    avg = sums / np.maximum(cnt, 1.0)[:, None]
    return np.where(cnt[:, None] > 0, avg - v, 0.0)


def boundary_vertices(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """[V] bool — vertices on a boundary edge (edge used by one triangle)."""
    e = np.concatenate([triangles[:, [0, 1]], triangles[:, [1, 2]],
                        triangles[:, [2, 0]]])
    e_sorted = np.sort(e, axis=1)
    uniq, counts = np.unique(e_sorted, axis=0, return_counts=True)
    b = np.zeros(len(vertices), bool)
    be = uniq[counts == 1]
    b[be.reshape(-1)] = True
    return b


def laplacian_smooth(
    vertices: np.ndarray,
    triangles: np.ndarray,
    n_iterations: int = 20,
    relaxation: float = 0.1,
    fix_boundary: bool = True,
) -> np.ndarray:
    """Uniform Laplacian smoothing: p += relaxation * (umbrella(p) - p)
    (MeshSmoothingLaplacianVTK's vtkSmoothPolyDataFilter defaults:
    NumIter=20, RelaxationFactor=0.01..0.1, BoundarySmoothing off here
    when fix_boundary)."""
    v = np.asarray(vertices, np.float32).copy()
    tri = np.asarray(triangles)
    fixed = boundary_vertices(v, tri) if fix_boundary else None
    src, dst = _edge_pairs(tri)
    cnt = np.bincount(src, minlength=len(v)).astype(v.dtype)
    for _ in range(n_iterations):
        delta = _umbrella(v, src, dst, cnt)
        if fixed is not None:
            delta[fixed] = 0.0
        v = v + relaxation * delta
    return v


def taubin_smooth(
    vertices: np.ndarray,
    triangles: np.ndarray,
    n_iterations: int = 20,
    lam: float = 0.5,
    mu: float = -0.53,
    fix_boundary: bool = False,
) -> np.ndarray:
    """Taubin lambda|mu smoothing — the non-shrinking low-pass filter that
    vtkWindowedSincPolyDataFilter implements (MeshSmoothingWindowedSincVTK).
    Each iteration: a shrink step (lam > 0) then an inflate step (mu < 0)."""
    v = np.asarray(vertices, np.float32).copy()
    tri = np.asarray(triangles)
    fixed = boundary_vertices(v, tri) if fix_boundary else None
    src, dst = _edge_pairs(tri)
    cnt = np.bincount(src, minlength=len(v)).astype(v.dtype)
    for _ in range(n_iterations):
        for step in (lam, mu):
            delta = _umbrella(v, src, dst, cnt)
            if fixed is not None:
                delta[fixed] = 0.0
            v = v + step * delta
    return v


def subdivide_linear(
    vertices: np.ndarray, triangles: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """One round of 1->4 linear subdivision (MeshSubdivisionVTK, LINEAR):
    new vertex at every unique edge midpoint; each triangle splits into 4."""
    v = np.asarray(vertices, np.float32)
    tri = np.asarray(triangles)
    e = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]])
    e_sorted = np.sort(e, axis=1)
    uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    mids = 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])
    mid_id = len(v) + inv.reshape(3, -1).T      # [F,3]: ids of m01, m12, m20
    v2 = np.concatenate([v, mids])
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    m01, m12, m20 = mid_id[:, 0], mid_id[:, 1], mid_id[:, 2]
    t2 = np.concatenate([
        np.stack([a, m01, m20], 1),
        np.stack([m01, b, m12], 1),
        np.stack([m20, m12, c], 1),
        np.stack([m01, m12, m20], 1),
    ])
    return v2, t2


def decimate_cluster(
    vertices: np.ndarray,
    triangles: np.ndarray,
    cell_size: Optional[float] = None,
    target_reduction: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex-clustering decimation (the batched stand-in for
    MeshQuadricDecimationVTK): vertices snapped to the centroid of their
    occupied grid cell, degenerate/duplicate triangles dropped. ``cell_size``
    defaults from ``target_reduction`` via the bbox diagonal."""
    v = np.asarray(vertices, np.float32)
    tri = np.asarray(triangles)
    if cell_size is None:
        bbox = v.max(0) - v.min(0)
        # aim for ~ (1-reduction) * V clusters
        n_target = max(int(len(v) * (1.0 - target_reduction)), 4)
        cell_size = float((np.prod(bbox.clip(1e-6)) / n_target) ** (1.0 / 3.0))
    cells = np.floor((v - v.min(0)) / cell_size).astype(np.int64)
    key = (cells[:, 0] << 42) | (cells[:, 1] << 21) | cells[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), 3), np.float64)
    np.add.at(sums, inv, v)
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    v2 = (sums / cnt[:, None]).astype(np.float32)
    t2 = inv[tri]
    # drop degenerate (collapsed) and duplicate triangles
    ok = (t2[:, 0] != t2[:, 1]) & (t2[:, 1] != t2[:, 2]) & (t2[:, 0] != t2[:, 2])
    t2 = t2[ok]
    t2 = np.unique(np.sort(t2, axis=1), axis=0)
    return v2, t2
