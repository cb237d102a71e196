"""Higher-level segmentation: LCCP and CPC object partitions, seeded-hue
flood fill, random walker, unary classifier.

Counterpart of ``pcl_tpu/segmentation/advanced.py``.

- ``lccp_segmentation`` (PCL's LCCPSegmentation): supervoxel adjacency by
  kNN of the centres, edges classified convex by the extended convexity and
  sanity criteria in one batched op, merged by union-find on the host.
- ``cpc_segmentation`` (PCL's CPCSegmentation): LCCP, then per segment a
  cutting plane through the concave edges' midpoints whose normal is their
  directions' principal axis, by a host SVD as in the JAX package (ROADMAP
  C57: another LAPACK build may return the axis with the other sign, which
  swaps the two halves' labels, not the cut).
- ``seeded_hue_segmentation`` (PCL's SeededHueSegmentation): a flood over
  the kNN graph within ``cluster_tolerance`` and ``delta_hue``; the host
  reads back the change flag once every 8 sweeps (C59).
- ``random_walker``: the combinatorial Dirichlet problem on the kNN graph
  Laplacian, one conjugate-gradient solve per label with
  ``jax.scipy.sparse.linalg.cg``'s rule: from 0, stop when ``|r|^2 <=
  (1e-5)^2 |b|^2`` or after ``cg_iters`` steps (C60). The labels' solves run
  together; each stops on its own test, and the host reads back once every
  16 steps whether any still runs.
- ``UnaryClassifier``: k-means codebooks per class (``ml.kmeans``, sampler
  and core: C61), nearest centroid at query time.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_RGB, Cloud, _device
from pcl_tpu_torch.features.shot import _f32
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.segmentation.supervoxel import SupervoxelResult

_HUE_CHECK_EVERY = 8          # flood sweeps between read-backs of the change flag
_CG_CHECK_EVERY = 16          # CG steps between read-backs of "does any label still run"


def _merge_labels_np(n: int, eu: np.ndarray, ev: np.ndarray) -> np.ndarray:
    """Union-find of ``n`` nodes over edges (host; ``n`` is the seed count)."""
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in zip(eu, ev):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(i) for i in range(n)])
    return np.unique(roots, return_inverse=True)[1]


def convexity_edges(centers: torch.Tensor, normals: torch.Tensor, adj_idx: torch.Tensor,
                    adj_ok: torch.Tensor, concavity_tolerance: float,
                    smoothness_check: float) -> torch.Tensor:
    """``[S, K]`` convex edges: ``n_i . d - n_j . d < concavity_tolerance``
    for the unit direction ``d`` from centre ``i`` to ``j``, and ``n_i . n_j
    > smoothness_check``."""
    ci = centers[:, None, :]
    d = centers[adj_idx] - ci
    dn = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    a1 = torch.sum(normals[:, None, :] * dn, dim=-1)
    a2 = torch.sum(normals[adj_idx] * dn, dim=-1)
    convex = (a1 - a2) < _f32(concavity_tolerance)
    convex = convex & (torch.sum(normals[:, None, :] * normals[adj_idx], dim=-1)
                       > _f32(smoothness_check))
    return convex & adj_ok


def _adjacency(sv: SupervoxelResult, k_adjacency: int):
    """The ``k_adjacency`` nearest other centres: ``(idx [S, K] int64, ok)``."""
    idx, _, ok = bruteforce.knn(sv.centers, sv.center_valid, sv.centers, k_adjacency + 1)
    return idx[:, 1:].long(), ok[:, 1:] & sv.center_valid[:, None]


def lccp_segmentation(sv: SupervoxelResult, concavity_tolerance: float = 0.17,
                      smoothness_threshold: float = 0.0, k_adjacency: int = 6,
                      min_segment_size: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Merge convexly connected supervoxels: ``(point_labels [N] int32,
    supervoxel_segment [S] int32)``."""
    S = sv.centers.shape[0]
    idx, ok = _adjacency(sv, k_adjacency)
    convex = convexity_edges(sv.centers, sv.normals, torch.clamp(idx, 0, S - 1), ok,
                             np.tan(concavity_tolerance),
                             np.cos(np.pi / 2) if smoothness_threshold == 0
                             else smoothness_threshold).cpu().numpy().reshape(-1)
    idx_np = idx.cpu().numpy()
    eu = np.repeat(np.arange(S), idx_np.shape[1])[convex]
    ev = idx_np.reshape(-1)[convex]
    seg_of_sv = _merge_labels_np(S, eu, ev)

    pl = sv.labels.cpu().numpy()
    point_labels = np.where(pl >= 0, seg_of_sv[np.clip(pl, 0, S - 1)], -1)
    if min_segment_size > 0:
        ids, cnt = np.unique(point_labels[point_labels >= 0], return_counts=True)
        point_labels = np.where(np.isin(point_labels, ids[cnt < min_segment_size]), -1,
                                point_labels)
    return point_labels.astype(np.int32), seg_of_sv.astype(np.int32)


def cpc_segmentation(cloud: Cloud, sv: SupervoxelResult, concavity_tolerance: float = 0.17,
                     min_cut_score: float = 0.2, k_adjacency: int = 6) -> np.ndarray:
    """LCCP, then constrained plane cuts: within each merged segment the
    concave edges' midpoints and directions vote for one cutting plane, and
    a segment with at least 3 such edges and ``min_cut_score`` of its
    supervoxels is split by it (cpc_segmentation.hpp applyCuttingPlane).
    Returns ``[N]`` int32 labels."""
    point_labels, seg_of_sv = lccp_segmentation(sv, concavity_tolerance,
                                                k_adjacency=k_adjacency)
    centers = sv.centers.cpu().numpy()
    valid = sv.center_valid.cpu().numpy()
    S = len(centers)
    idx_t, ok_t = _adjacency(sv, k_adjacency)
    convex = convexity_edges(sv.centers, sv.normals, torch.clamp(idx_t, 0, S - 1), ok_t,
                             np.tan(concavity_tolerance), 0.0).cpu().numpy()
    idx, ok = idx_t.cpu().numpy(), ok_t.cpu().numpy()
    concave = ok & ~convex

    xyz = cloud.xyz.cpu().numpy()
    out = point_labels.copy()
    next_label = out.max() + 1 if out.size else 0
    for seg in np.unique(seg_of_sv):
        svs = np.flatnonzero((seg_of_sv == seg) & valid)
        if len(svs) < 2:
            continue
        mids, dirs = [], []
        for s in svs:
            for j, o in zip(idx[s], concave[s]):
                if o and seg_of_sv[j] == seg:
                    mids.append(0.5 * (centers[s] + centers[j]))
                    dirs.append(centers[j] - centers[s])
        if len(mids) < 3 or len(mids) < min_cut_score * len(svs):
            continue
        mids = np.asarray(mids)
        dirs = np.asarray(dirs)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-12
        nrm = np.linalg.svd(dirs, full_matrices=False)[2][0]
        d0 = -nrm @ mids.mean(0)
        pts_mask = out == seg
        side = (xyz @ nrm + d0) > 0
        if (pts_mask & side).sum() > 0 and (pts_mask & ~side).sum() > 0:
            out[pts_mask & side] = next_label
            next_label += 1
    return out.astype(np.int32)


def hue(rgb: torch.Tensor) -> torch.Tensor:
    """Hue in ``[0, 1)`` of ``[N, 3]`` colours (0 where grey)."""
    mx, mn = rgb.amax(-1), rgb.amin(-1)
    c = mx - mn
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    h = torch.where(mx == r, torch.remainder((g - b) / (c + 1e-12), 6.0),
                    torch.where(mx == g, (b - r) / (c + 1e-12) + 2.0, (r - g) / (c + 1e-12) + 4.0))
    return torch.where(c < 1e-9, 0.0, h) / 6.0


def seeded_hue_segmentation(cloud: Cloud, seed_mask: torch.Tensor, cluster_tolerance: float,
                            delta_hue: float = 0.1, k: int = 12, max_sweeps: int = 64
                            ) -> torch.Tensor:
    """Flood from the seeds over the kNN graph, through pairs within
    ``cluster_tolerance`` whose circular hue difference is under
    ``delta_hue``: ``[N]`` bool membership. The flood runs to its fixed point
    (``max_sweeps`` is kept for the JAX signature, whose loop ignores it)."""
    if ATTR_RGB not in cloud.attrs:
        raise ValueError("seeded_hue_segmentation requires rgb")
    h = hue(cloud.attrs[ATTR_RGB])
    n = cloud.capacity
    idx, d2, ok = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, k + 1)
    idxc = torch.clamp(idx[:, 1:].long(), 0, n - 1)
    d2, ok = d2[:, 1:], ok[:, 1:] & cloud.mask[:, None]
    hd = torch.abs(h[:, None] - h[idxc])
    hd = torch.minimum(hd, 1.0 - hd)
    t32 = np.float32(cluster_tolerance)
    edge = ok & (d2 <= float(t32 * t32)) & (hd < _f32(delta_hue))
    member = torch.as_tensor(seed_mask, device=cloud.xyz.device) & cloud.mask
    while True:
        before = member
        for _ in range(_HUE_CHECK_EVERY):
            member = (member | (member[idxc] & edge).any(dim=1)) & cloud.mask
        if not bool(torch.any(member != before)):
            return member


def walker_probabilities(cloud: Cloud, seed_labels: torch.Tensor, k: int = 10,
                         sigma: float = 0.1, n_labels: int = 4, cg_iters: int = 200
                         ) -> torch.Tensor:
    """``[n_labels, N]`` arrival probabilities: 1 and 0 at the seeds, at the
    other points the solution of ``L_uu x = W_us m_s`` on the kNN graph with
    weights ``exp(-d^2 / sigma^2)``."""
    n = cloud.capacity
    dev = cloud.xyz.device
    seed_labels = torch.as_tensor(seed_labels, device=dev).long()
    idx, d2, ok = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, k + 1)
    idxc = torch.clamp(idx[:, 1:].long(), 0, n - 1)
    d2, ok = d2[:, 1:], ok[:, 1:] & cloud.mask[:, None]
    s32 = np.float32(sigma)
    w = torch.where(ok, torch.exp(-d2 / float(s32 * s32)), 0.0)
    deg = w.sum(dim=1)
    seeded = seed_labels >= 0
    unseeded = ~seeded & cloud.mask

    def matvec(x):                     # [L, N]: L_uu on the unseeded block, I on the rest
        xu = torch.where(unseeded, x, 0.0)
        y = (deg + 1e-6) * xu - (w * xu[:, idxc]).sum(dim=-1)
        return torch.where(unseeded, y, x)

    labels = torch.arange(n_labels, device=dev)[:, None]
    m_s = torch.where(seeded & (seed_labels == labels), 1.0, 0.0)
    b = torch.where(unseeded, (w * m_s[:, idxc]).sum(dim=-1), 0.0)
    x = torch.zeros_like(b)
    r, p = b, b
    gamma = torch.sum(r * r, dim=1)
    atol2 = float(np.float32(1e-5) ** 2) * torch.sum(b * b, dim=1)
    active = gamma > atol2
    for step in range(cg_iters):
        if step % _CG_CHECK_EVERY == 0 and not bool(active.any()):
            break
        Ap = matvec(p)
        alpha = gamma / torch.sum(p * Ap, dim=1)
        x_ = x + alpha[:, None] * p
        r_ = r - alpha[:, None] * Ap
        gamma_ = torch.sum(r_ * r_, dim=1)
        p_ = r_ + (gamma_ / gamma)[:, None] * p
        a = active[:, None]
        x, r, p = torch.where(a, x_, x), torch.where(a, r_, r), torch.where(a, p_, p)
        gamma = torch.where(active, gamma_, gamma)
        active = active & (gamma > atol2)
    return torch.where(seeded, m_s, x)


def random_walker(cloud: Cloud, seed_labels: torch.Tensor, k: int = 10, sigma: float = 0.1,
                  n_labels: int = 4, cg_iters: int = 200) -> torch.Tensor:
    """Label unseeded points by their random walkers' arrival probabilities
    (the first label on a tie). ``seed_labels [N]``: -1 unseeded, else a
    label in ``[0, n_labels)``. Returns ``[N]`` int32 labels, -1 where
    masked."""
    seed_labels = torch.as_tensor(seed_labels, device=cloud.xyz.device).long()
    P = walker_probabilities(cloud, seed_labels, k, sigma, n_labels, cg_iters)
    out = torch.where(seed_labels >= 0, seed_labels, torch.argmax(P, dim=0))
    return torch.where(cloud.mask, out, -1).to(torch.int32)


class UnaryClassifier:
    """Nearest-centroid classifier over per-point features (PCL's
    UnaryClassifier: k-means codebooks per class, the nearest centroid's
    class at query time)."""

    def __init__(self):
        self.centroids: Optional[np.ndarray] = None
        self.class_of: Optional[np.ndarray] = None

    def train(self, features_per_class: Sequence, clusters_per_class: int = 8,
              init_indices: Optional[Sequence] = None,
              generator: Optional[torch.Generator] = None, device=None) -> "UnaryClassifier":
        """K-means (20 iterations at most) of each class's features on
        ``device`` (default CUDA); ``init_indices[c]``, when given, are class
        ``c``'s initial centroids' rows, else ``generator`` draws them."""
        from pcl_tpu_torch.ml.kmeans import kmeans_core, kmeans_init_indices

        dev = _device(device)
        cents, cls = [], []
        for ci, feats in enumerate(features_per_class):
            f = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
            kk = min(clusters_per_class, len(feats))
            m = torch.ones(f.shape[0], dtype=torch.bool, device=dev)
            init = (kmeans_init_indices(m, kk, generator) if init_indices is None
                    else torch.as_tensor(init_indices[ci], device=dev))
            c, _, _ = kmeans_core(f, m, kk, init, max_iterations=20)
            cents.append(c.cpu().numpy())
            cls.append(np.full(kk, ci))
        self.centroids = np.concatenate(cents, 0)
        self.class_of = np.concatenate(cls, 0)
        return self

    def segment(self, features: np.ndarray) -> np.ndarray:
        """The class of each feature row's nearest centroid (host)."""
        f = np.asarray(features, np.float32)
        d = ((f[:, None, :] - self.centroids[None]) ** 2).sum(-1)
        return self.class_of[d.argmin(1)].astype(np.int32)
