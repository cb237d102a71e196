"""Graph-cut segmentation: MinCut and GrabCut.

Counterpart of ``pcl_tpu/segmentation/graphcut.py``.

- ``min_cut_segmentation`` (PCL's MinCutSegmentation): a kNN graph with
  smoothness capacities ``exp(-(d / sigma)^2)`` and unary capacities from
  the distance to the foreground point against ``radius``, built on the
  cloud's device; the s-t cut runs on the host with scipy's
  ``maximum_flow`` on capacities rounded to integers at ``_CAP_SCALE``, as
  in the JAX package (ROADMAP C58: a weight within an ulp of a half may
  round to the other integer).
- ``grab_cut`` (PCL's GrabCut): iterated cuts with per-side k-means colour
  models, host numpy with its own seeded numpy draws (C61).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_RGB, Cloud
from pcl_tpu_torch.features.shot import _f32
from pcl_tpu_torch.search import bruteforce

_CAP_SCALE = 10_000.0        # scipy's max-flow takes integer capacities


def mincut_weights(xyz: torch.Tensor, mask: torch.Tensor, center, sigma: float, radius: float,
                   source_weight: float, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(neighbours [N, k], smoothness [N, k], source capacity [N], sink
    capacity [N])``: the source link ``w exp(-(d_c / radius)^2)``, the sink
    link ``w (d_c / radius)^2`` for the distance ``d_c`` to ``center``."""
    idx, d2, valid = bruteforce.knn(xyz, mask, xyz, k + 1)
    idx, d2, valid = idx[:, 1:], d2[:, 1:], valid[:, 1:] & mask[:, None]
    s32 = np.float32(sigma)
    smooth = torch.where(valid, torch.exp(-d2 / float(s32 * s32)), 0.0)
    center = torch.as_tensor(np.asarray(center, np.float32), device=xyz.device)
    dc = torch.linalg.vector_norm(xyz - center[None, :], dim=-1)
    q = (dc / _f32(radius)) ** 2
    sw = _f32(source_weight)
    return (idx, smooth, torch.where(mask, sw * torch.exp(-q), 0.0),
            torch.where(mask, sw * q, 0.0))


def max_flow_binary_labels(n: int, edges_u: np.ndarray, edges_v: np.ndarray,
                           edge_cap: np.ndarray, src_cap: np.ndarray,
                           sink_cap: np.ndarray) -> np.ndarray:
    """s-t minimum cut of an undirected weighted graph (host, scipy):
    ``[n]`` bool, True on the source (foreground) side."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow

    S, T = n, n + 1
    uu = np.concatenate([edges_u, edges_v, np.full(n, S), np.arange(n)])
    vv = np.concatenate([edges_v, edges_u, np.arange(n), np.full(n, T)])
    cc = np.concatenate([edge_cap, edge_cap, src_cap, sink_cap])
    cap = np.rint(cc * _CAP_SCALE).astype(np.int64)
    keep = cap > 0
    g = csr_matrix((cap[keep], (uu[keep], vv[keep])), shape=(n + 2, n + 2))
    res = maximum_flow(g.astype(np.int32), S, T)
    # the source side: reachable from S in the residual graph
    residual = g - res.flow
    residual.data = np.maximum(residual.data, 0)
    order = breadth_first_order((residual > 0).astype(np.int8), S, directed=True,
                                return_predecessors=False)
    fg = np.zeros(n + 2, bool)
    fg[order] = True
    return fg[:n]


def min_cut_segmentation(cloud: Cloud, foreground_point: np.ndarray, sigma: float = 0.25,
                         radius: float = 4.0, source_weight: float = 0.8, k: int = 14
                         ) -> np.ndarray:
    """Foreground mask ``[N]`` bool (setSigma, setRadius, setSourceWeight,
    setNumberOfNeighbours)."""
    idx, smooth, src, snk = mincut_weights(cloud.xyz, cloud.mask, foreground_point, sigma,
                                           radius, source_weight, k)
    n = cloud.capacity
    idx = idx.cpu().numpy()
    u = np.repeat(np.arange(n), idx.shape[1])
    v = idx.reshape(-1)
    c = smooth.cpu().numpy().reshape(-1)
    ok = c > 0
    return max_flow_binary_labels(n, u[ok], v[ok], c[ok], src.cpu().numpy(), snk.cpu().numpy())


def _kmeans_np(x: np.ndarray, k: int, iters: int = 10, seed: int = 0):
    rng = np.random.default_rng(seed)
    if len(x) == 0:
        return np.zeros((k, x.shape[1])), np.full(k, 1e9)
    c = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    if len(c) < k:
        c = np.concatenate([c, np.tile(c[-1:], (k - len(c), 1))])
    for _ in range(iters):
        a = ((x[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)
        for j in range(k):
            if (a == j).any():
                c[j] = x[a == j].mean(0)
    a = ((x[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)
    var = np.array([x[a == j].var() * 3 + 1e-4 if (a == j).any() else 1e9 for j in range(k)])
    return c, var


def _nll(x: np.ndarray, centers: np.ndarray, var: np.ndarray) -> np.ndarray:
    d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    ll = -0.5 * d / var[None] - 1.5 * np.log(var[None] + 1e-12)
    return -ll.max(1)                      # the best component's negative log likelihood


def grab_cut(cloud: Cloud, initial_foreground: np.ndarray, lam: float = 50.0,
             k_components: int = 5, iterations: int = 3, k_neighbors: int = 8) -> np.ndarray:
    """Iterated colour-model graph cuts: outside ``initial_foreground`` [N]
    is hard background (TrimapBackground), inside is refined. Returns the
    refined ``[N]`` bool."""
    if ATTR_RGB not in cloud.attrs:
        raise ValueError("grab_cut requires rgb")
    mask = cloud.mask.cpu().numpy()
    rgb = cloud.attrs[ATTR_RGB].cpu().numpy()
    n = len(mask)
    idx, _, valid = (a.cpu().numpy() for a in bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz,
                                                             k_neighbors + 1))
    idx, valid = idx[:, 1:], valid[:, 1:] & mask[:, None]
    # the colour-contrast pairwise term (GrabCut's beta)
    cdiff = ((rgb[:, None, :] - rgb[idx]) ** 2).sum(-1)
    beta = 1.0 / (2.0 * max(cdiff[valid].mean(), 1e-8))
    c = np.where(valid, lam * np.exp(-beta * cdiff), 0.0).reshape(-1)
    u = np.repeat(np.arange(n), idx.shape[1])
    v = idx.reshape(-1)
    ok = c > 0

    hard_bg = mask & ~initial_foreground
    BIG = 1e5
    fg = initial_foreground.copy() & mask
    for _ in range(iterations):
        fc, fv = _kmeans_np(rgb[fg], k_components, seed=1)
        bc, bv = _kmeans_np(rgb[mask & ~fg], k_components, seed=2)
        src = np.where(mask, _nll(rgb, bc, bv), 0.0)
        snk = np.where(mask, _nll(rgb, fc, fv), 0.0)
        src = np.where(hard_bg, 0.0, np.minimum(src, BIG))
        snk = np.where(hard_bg, BIG, np.minimum(snk, BIG))
        new_fg = max_flow_binary_labels(n, u[ok], v[ok], c[ok], src, snk) & mask
        if (new_fg == fg).all():
            break
        fg = new_fg
    return fg
