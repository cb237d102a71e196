"""Pluggable pose-graph optimiser, PCL's GraphOptimizer/GraphHandler surface.

Counterpart of ``pcl_tpu/registration/graph_optimizer.py``. ``PoseGraph`` holds
vertices (scan poses) and edges (correspondence sets) on the host;
``optimize(method=...)`` runs a registered backend on ``device`` (default
CUDA) and returns the ``[V, 4, 4]`` poses as numpy. Backends:

  'lum'         dense 6Vx6V LUM solve        (registration/graph.py:lum)
  'lum_cg'      block-Jacobi CG, O(E) memory (lum(..., solver='cg'))
  'lum_sharded' edge-sharded CG over the ranks of a mesh
                (parallel/graph_sharded.py:sharded_lum; ``mesh=``, by default
                ``make_mesh(device=device)``, closed afterwards: a one-rank
                group it formed is destroyed)
  'elch'        chain loop-closure distribution (graph.py:elch_distribute)

``register_optimizer(name, fn)`` adds a backend ``fn(graph, **kw) -> [V,4,4]``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.registration import graph as _graph

_REGISTRY: Dict[str, Callable] = {}


def register_optimizer(name: str, fn: Callable) -> None:
    _REGISTRY[name] = fn


class PoseGraph:
    """Vertex/edge container mirroring LUM's addPointCloud/setCorrespondences
    with a pluggable solve."""

    def __init__(self):
        self._poses: List[np.ndarray] = []
        self._edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []

    def add_vertex(self, pose: Optional[np.ndarray] = None) -> int:
        """Add a scan vertex; returns its index (LUM addPointCloud)."""
        self._poses.append(
            np.eye(4, dtype=np.float32) if pose is None else np.asarray(pose, np.float32))
        return len(self._poses) - 1

    def add_edge(self, i: int, j: int, src_pts, dst_pts) -> None:
        """Correspondence edge: points of scan i matched to scan j (LUM
        setCorrespondences)."""
        self._edges.append((i, j, np.asarray(src_pts, np.float32),
                            np.asarray(dst_pts, np.float32)))

    @property
    def n_vertices(self) -> int:
        return len(self._poses)

    @property
    def n_edges(self) -> int:
        return len(self._edges)

    def poses(self) -> np.ndarray:
        return np.stack(self._poses) if self._poses else np.zeros((0, 4, 4))

    def optimize(self, method: str = "lum", **kw) -> np.ndarray:
        """Run the selected backend; updates and returns the [V,4,4] poses."""
        if method not in _REGISTRY:
            raise ValueError(f"unknown optimizer {method!r}; have {sorted(_REGISTRY)}")
        new_poses = _REGISTRY[method](self, **kw)
        if isinstance(new_poses, torch.Tensor):
            new_poses = new_poses.cpu().numpy()
        new_poses = np.asarray(new_poses)
        self._poses = [p for p in new_poses]
        return new_poses


def _prep(graph: PoseGraph, max_corr: Optional[int], device):
    if max_corr is None:
        max_corr = max((len(s) for _, _, s, _ in graph._edges), default=1)
    dev = _device(device)
    return (torch.from_numpy(np.asarray(graph.poses(), np.float32)).to(dev),
            *_graph.build_edges_from_correspondences(graph._edges, max_corr, device=dev))


def _lum_backend(graph: PoseGraph, max_corr=None, solver="dense", device=None, **kw):
    P, es, ed, cs, cd, cv = _prep(graph, max_corr, device)
    return _graph.lum(P, es, ed, cs, cd, cv, solver=solver, **kw).poses


def _lum_cg_backend(graph: PoseGraph, max_corr=None, device=None, **kw):
    return _lum_backend(graph, max_corr=max_corr, solver="cg", device=device, **kw)


def _lum_sharded_backend(graph: PoseGraph, mesh=None, max_corr=None, device=None, **kw):
    from pcl_tpu_torch.parallel.graph_sharded import sharded_lum
    from pcl_tpu_torch.parallel.mesh import make_mesh
    own = mesh is None
    if own:
        mesh = make_mesh(device=device)
    try:
        P, es, ed, cs, cd, cv = _prep(graph, max_corr, mesh.device)
        return sharded_lum(mesh, P, es, ed, cs, cd, cv, **kw).poses
    finally:
        if own:
            mesh.close()


def _elch_backend(graph: PoseGraph, loop_transform=None, device=None, **kw):
    if loop_transform is None:
        raise ValueError("elch backend needs loop_transform=")
    dev = _device(device)
    return _graph.elch_distribute(
        torch.from_numpy(np.asarray(graph.poses(), np.float32)).to(dev),
        torch.tensor(np.asarray(loop_transform, np.float32), device=dev))


register_optimizer("lum", _lum_backend)
register_optimizer("lum_cg", _lum_cg_backend)
register_optimizer("lum_sharded", _lum_sharded_backend)
register_optimizer("elch", _elch_backend)
