"""Implicit Shape Model: codebook voting for object centres.

Counterpart of ``pcl_tpu/recognition/ism.py`` (PCL's
implicit_shape_model.hpp: trainISM, findObjects, ISMVoteList,
ISMModel::saveModelToFile / loadModelFromfile), mostly numpy host code
copied as it is (ROADMAP C62):

  1. ``simplify_cloud``: per occupied voxel, the original point nearest
     the voxel's centroid;
  2. per object, the centre shift and each word's direction to the centre
     in its normal-aligned frame (``align_y_with_normal``);
  3. a k-means codebook of the word descriptors, five attempts, the least
     inertia kept: ``ml.kmeans.kmeans_core`` from initial indices that the
     caller gives or :func:`cluster_init_indices` draws (C17, C61);
  4. per-class sigmas and the statistical and learned weights;
  5. recognition: each keypoint's nearest codebook centre (the
     matrix-product identity, on the device), one vote per same-class word,
     and mean-shift peaks.

The votes take ``R d`` where PCL takes ``R^T d`` (ROADMAP C2): the port
copies the reference. A feature function takes numpy points and normals and
may return an array or a tensor (C52). The model file is the reference's
text format, byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.ml.kmeans import kmeans_core, kmeans_init_indices

_EPS = np.finfo(np.float32).eps


# ---------------------------------------------------------------------------
# model container + reference-format serialization


@dataclass
class ISMModel:
    """Mirror of pcl::features::ISMModel (implicit_shape_model.h:461)."""

    statistical_weights: np.ndarray   # [n_classes, K]
    learned_weights: np.ndarray       # [V] f32
    classes: np.ndarray               # [V] int32 class of each visual word
    sigmas: np.ndarray                # [n_classes] f32
    directions_to_center: np.ndarray  # [V,3] normal-frame dir to center
    clusters_centers: np.ndarray      # [K,D] descriptor centroids
    clusters: List[List[int]]         # K lists of visual-word indices
    n_classes: int
    n_visual_words: int
    n_clusters: int
    dim: int


def save_ism_model(model: ISMModel, path: str) -> None:
    """Write the reference text format (ISMModel::saveModelToFile,
    implicit_shape_model.hpp:342): header ints then statistical weights,
    learned weights, classes, sigmas, directions, cluster centers and
    member lists, all space-separated."""
    parts: List[str] = [
        str(model.n_classes), str(model.n_visual_words),
        str(model.n_clusters), str(model.dim),
    ]

    def fmt(x: float) -> str:
        return f"{float(x):.6g}"  # C++ default operator<< precision

    parts += [fmt(w) for w in np.asarray(model.statistical_weights).ravel()]
    parts += [fmt(w) for w in np.asarray(model.learned_weights).ravel()]
    parts += [str(int(c)) for c in np.asarray(model.classes).ravel()]
    parts += [fmt(s) for s in np.asarray(model.sigmas).ravel()]
    parts += [fmt(d) for d in np.asarray(model.directions_to_center).ravel()]
    parts += [fmt(c) for c in np.asarray(model.clusters_centers).ravel()]
    for members in model.clusters:
        parts.append(str(len(members)))
        parts += [str(int(m)) for m in members]
    with open(path, "w") as f:
        f.write(" ".join(parts) + " ")


def load_ism_model(path: str) -> ISMModel:
    """Parse the reference text format (ISMModel::loadModelFromfile,
    implicit_shape_model.hpp:412)."""
    with open(path) as f:
        tok = f.read().split()
    pos = 0

    def take(n: int) -> List[str]:
        nonlocal pos
        out = tok[pos:pos + n]
        pos += n
        return out

    n_classes, n_words, n_clusters, dim = (int(t) for t in take(4))
    sw = np.array(take(n_classes * n_clusters), np.float32).reshape(
        n_classes, n_clusters)
    lw = np.array(take(n_words), np.float32)
    cls = np.array(take(n_words), np.int32)
    sig = np.array(take(n_classes), np.float32)
    dirs = np.array(take(n_words * 3), np.float32).reshape(n_words, 3)
    centers = np.array(take(n_clusters * dim), np.float32).reshape(
        n_clusters, dim)
    clusters: List[List[int]] = []
    for _ in range(n_clusters):
        sz = int(take(1)[0])
        clusters.append([int(t) for t in take(sz)])
    return ISMModel(sw, lw, cls, sig, dirs, centers, clusters,
                    n_classes, n_words, n_clusters, dim)


# ---------------------------------------------------------------------------
# geometry helpers


def align_y_with_normal(normals: np.ndarray) -> np.ndarray:
    """Batched alignYCoordWithNormal (implicit_shape_model.hpp:1164):
    returns [N,3,3] rotations R = Rx * Rz with A/B built from the normal
    components. Degenerate normals (ny=nz=0 or nx=ny=0, where the
    reference divides by zero) get an epsilon-guarded denominator."""
    n = np.asarray(normals, np.float32)
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    den_x = np.sqrt(nz * nz + ny * ny)
    den_z = np.sqrt(nx * nx + ny * ny)
    den_x = np.where(den_x < _EPS, 1.0, den_x)
    den_z = np.where(den_z < _EPS, 1.0, den_z)
    ax, bx = ny / den_x, -nz / den_x
    az, bz = ny / den_z, -nx / den_z
    zeros = np.zeros_like(ax)
    ones = np.ones_like(ax)
    rx = np.stack([
        ones, zeros, zeros,
        zeros, ax, -bx,
        zeros, bx, ax,
    ], -1).reshape(-1, 3, 3)
    rz = np.stack([
        az, -bz, zeros,
        bz, az, zeros,
        zeros, zeros, ones,
    ], -1).reshape(-1, 3, 3)
    return np.einsum("nij,njk->nik", rx, rz)


def simplify_cloud(points: np.ndarray, sampling_size: float) -> np.ndarray:
    """Voxel sampling that keeps the original point closest to each
    occupied leaf's centroid (simplifyCloud, hpp:1086). Returns indices
    into ``points`` ordered by leaf index (the reference's VoxelGrid
    output order)."""
    p = np.asarray(points, np.float32)
    ijk = np.floor(p / np.float32(sampling_size)).astype(np.int64)
    ijk -= ijk.min(axis=0)
    dims = ijk.max(axis=0) + 1
    key = (ijk[:, 2] * dims[1] + ijk[:, 1]) * dims[0] + ijk[:, 0]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    counts = np.diff(np.r_[starts, len(ks)])
    # leaf centroids
    csum = np.add.reduceat(p[order], starts, axis=0)
    cent = csum / counts[:, None]
    # distance of each point to its leaf centroid; argmin per leaf
    seg = np.repeat(np.arange(len(starts)), counts)
    d = np.sum((p[order] - cent[seg]) ** 2, axis=1)
    best = np.full(len(starts), -1, np.int64)
    bestd = np.full(len(starts), np.inf, np.float32)
    np.minimum.at(bestd, seg, d)
    hit = d == bestd[seg]
    # first hit per segment wins (ties: lowest original index in leaf order)
    first = np.zeros(len(ks), bool)
    idx_hit = np.flatnonzero(hit)
    seg_hit = seg[idx_hit]
    keep = np.r_[True, seg_hit[1:] != seg_hit[:-1]]
    first[idx_hit[keep]] = True
    best = order[first]
    return best


# ---------------------------------------------------------------------------
# training


def _host(x) -> np.ndarray:
    """A feature function's result as a float32 array (it may return a
    tensor, ROADMAP C52)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def cluster_init_indices(n: int, k: int, attempts: int = 5, device=None,
                         gen: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    """The sampler of :func:`_cluster_descriptors`: each attempt's initial
    centroid indices (``ml.kmeans.kmeans_init_indices``), from ``gen`` or,
    where none is given, from a generator seeded with the attempt's number
    (the reference's ``PRNGKey(a)``)."""
    dev = _device(device)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    out = []
    for a in range(attempts):
        g = gen
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(a)
        out.append(kmeans_init_indices(mask, k, g))
    return out


def _cluster_descriptors(desc: np.ndarray, k: int, init_indices: Sequence[torch.Tensor],
                         iters: int = 10, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """clusterDescriptors (hpp:883): k-means from each attempt's initial
    indices, the least inertia kept."""
    best = None
    dev = init_indices[0].device if device is None else _device(device)
    x = torch.as_tensor(desc, device=dev)
    mask = torch.ones(len(desc), dtype=torch.bool, device=dev)
    for init in init_indices:
        cent, labels, _ = kmeans_core(x, mask, k, init.to(dev), max_iterations=iters)
        cent_n = cent.cpu().numpy()
        lab_n = labels.cpu().numpy()
        inertia = float(np.sum((desc - cent_n[lab_n]) ** 2))
        if best is None or inertia < best[0]:
            best = (inertia, cent_n, lab_n)
    return best[1], best[2]


def _calculate_sigmas(centered_clouds: Sequence[np.ndarray],
                      classes: Sequence[int]) -> np.ndarray:
    """calculateSigmas (hpp:905): per-class mean over objects of
    sqrt(max_{i<j} x_i . x_j) / 10, on the center-shifted clouds (the
    reference mutates its stored clouds in extractDescriptors before
    this runs). The accumulated quantity is the raw dot product —
    reproduced as written."""
    n_classes = int(max(classes)) + 1
    per_class: List[List[float]] = [[] for _ in range(n_classes)]
    for cloud, cl in zip(centered_clouds, classes):
        x = np.asarray(cloud, np.float32)
        # max over ordered pairs i<j of the dot product, blocked matmul
        maxd = 0.0
        bs = 2048
        for i0 in range(0, len(x), bs):
            g = x[i0:i0 + bs] @ x.T            # [b, N]
            # mask the diagonal-and-below of the global pair matrix
            rows = np.arange(i0, i0 + g.shape[0])[:, None]
            g = np.where(np.arange(len(x))[None, :] > rows, g, -np.inf)
            if g.size:
                maxd = max(maxd, float(g.max()))
        per_class[int(cl)].append(float(np.sqrt(max(maxd, 0.0))))
    sig = np.zeros(n_classes, np.float32)
    for c in range(n_classes):
        if per_class[c]:
            sig[c] = np.sum(per_class[c]) / (len(per_class[c]) * 10.0)
    return sig


def _calculate_weights(
    word_points: np.ndarray,       # [V,3] sampled keypoint (centered frame)
    word_dirs: np.ndarray,         # [V,3] stored (normal-frame) directions
    word_rot: np.ndarray,          # [V,3,3] alignYCoordWithNormal(normal_v)
    word_class: np.ndarray,        # [V]
    labels: np.ndarray,            # [V] cluster of each word
    sigmas: np.ndarray,
    n_clusters: int,
    n_classes: int,
    n_vot_on: bool = True,
) -> Tuple[np.ndarray, np.ndarray, List[List[int]]]:
    """calculateWeights (hpp:956). Returns (statistical [C,K],
    learned [V], clusters)."""
    V = len(word_points)
    clusters: List[List[int]] = [[] for _ in range(n_clusters)]
    for i, l in enumerate(labels):
        clusters[int(l)].append(i)

    n_vot_2 = np.zeros((n_clusters, n_classes), np.int64)
    np.add.at(n_vot_2, (labels, word_class), 1)
    n_vot = n_vot_2.sum(axis=1)                    # votes per cluster
    n_ftr = np.bincount(word_class, minlength=n_classes)  # words per class
    n_vw = (n_vot_2 > 0).sum(axis=0)               # clusters voting per class

    # learned weights: median Gaussian agreement within (cluster, class)
    learned = np.zeros(V, np.float32)
    for members in clusters:
        if not members:
            continue
        m = np.asarray(members)
        for i in m:
            c = int(word_class[i])
            s2 = float(sigmas[c]) ** 2
            if s2 < _EPS:
                continue
            same = m[word_class[m] == c]
            # actual center: i's direction re-rotated by i's own basis
            # (the reference applies the NON-transposed transform to the
            # already-rotated stored direction — hpp:1025, kept verbatim)
            a = word_points[i] + word_rot[i] @ word_dirs[i]
            # predicted centers: i's direction rotated by each j's basis
            pred = word_points[same] + np.einsum(
                "njk,k->nj", word_rot[same], word_dirs[i])
            res2 = np.sum((pred - a) ** 2, axis=1)
            g = np.exp(-res2 / s2)
            mid = (len(g) - 1) // 2
            learned[i] = np.partition(g, mid)[mid]

    # statistical weights
    stat = np.zeros((n_classes, n_clusters), np.float32)
    for kcl in range(n_clusters):
        for c in range(n_classes):
            if (n_vot_2[kcl, c] == 0 or n_vw[c] == 0 or n_vot[kcl] == 0
                    or n_ftr[c] == 0):
                continue
            part_1 = float(n_vw[c])
            part_2 = float(n_vot[kcl]) if n_vot_on else 1.0
            part_3 = float(n_vot_2[kcl, c]) / float(n_ftr[c])
            part_4 = sum(
                float(n_vot_2[kcl, j]) / float(n_ftr[j])
                for j in range(n_classes) if n_ftr[j] != 0)
            stat[c, kcl] = (1.0 / part_1) * (1.0 / part_2) * part_3 / part_4
    return stat, learned, clusters


def train_ism(
    clouds: Sequence[np.ndarray],
    normals: Sequence[np.ndarray],
    classes: Sequence[int],
    feature_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    sampling_size: float = 0.1,
    n_clusters: int = 184,
    training_sigmas: Optional[Sequence[float]] = None,
    n_vot_on: bool = True,
    init_indices: Optional[Sequence[torch.Tensor]] = None,
    gen: Optional[torch.Generator] = None,
    device=None,
) -> ISMModel:
    """trainISM (implicit_shape_model.hpp:660). ``feature_fn(points,
    normals) -> [N,D]`` plays the reference's pluggable feature
    estimator (the test pairing is FPFH). Defaults mirror the header:
    sampling_size 0.1, 184 clusters (implicit_shape_model.h:598/604). The
    codebook's k-means runs on ``device`` (default CUDA) from
    ``init_indices`` (five attempts' initial centroid indices) or from draws
    of :func:`cluster_init_indices`."""
    word_desc: List[np.ndarray] = []
    word_points: List[np.ndarray] = []
    word_dirs: List[np.ndarray] = []
    word_rot: List[np.ndarray] = []
    word_class: List[int] = []
    centered: List[np.ndarray] = []

    for obj, (cloud, nrm, cl) in enumerate(zip(clouds, normals, classes)):
        cloud = np.asarray(cloud, np.float32)
        nrm = np.asarray(nrm, np.float32)
        center = cloud.mean(axis=0)
        keep = simplify_cloud(cloud, sampling_size)
        if len(keep) == 0:
            centered.append(cloud - center)
            continue
        pts = cloud[keep] - center           # shiftCloud on the sampled set
        nn = nrm[keep]
        centered.append(cloud - center)
        desc = _host(feature_fn(pts, nn))
        good = desc.sum(axis=1) >= _EPS      # skip all-zero descriptors
        pts, nn, desc = pts[good], nn[good], desc[good]
        rot = align_y_with_normal(nn)
        dirs = np.einsum("nij,nj->ni", rot, -pts)   # R * (0 - p)
        word_desc.append(desc)
        word_points.append(pts)
        word_dirs.append(dirs)
        word_rot.append(rot)
        word_class += [int(cl)] * len(pts)

    desc = np.concatenate(word_desc)
    pts = np.concatenate(word_points)
    dirs = np.concatenate(word_dirs)
    rots = np.concatenate(word_rot)
    wcls = np.asarray(word_class, np.int32)
    n_classes = int(max(classes)) + 1

    k = min(n_clusters, len(desc))
    if init_indices is None:
        init_indices = cluster_init_indices(len(desc), k, device=device, gen=gen)
    centers, labels = _cluster_descriptors(desc, k, init_indices, device=device)

    if training_sigmas is not None and len(training_sigmas):
        sigmas = np.asarray(training_sigmas, np.float32)
    else:
        sigmas = _calculate_sigmas(centered, classes)

    stat, learned, clusters = _calculate_weights(
        pts, dirs, rots, wcls, labels, sigmas, k, n_classes, n_vot_on)

    return ISMModel(stat, learned, wcls, sigmas, dirs, centers, clusters,
                    n_classes, len(desc), k, desc.shape[1])


# ---------------------------------------------------------------------------
# recognition


def _nearest_cluster(desc: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The nearest centre of each descriptor by the matrix-product identity
    ``|d|^2 - 2 d.c + |c|^2`` (the reference's formula)."""
    d = (torch.sum(desc * desc, 1)[:, None] - 2.0 * desc @ centers.T
         + torch.sum(centers * centers, 1)[None])
    return torch.argmin(d, dim=1)


def find_objects(
    model: ISMModel,
    cloud: np.ndarray,
    normals: np.ndarray,
    class_of_interest: int,
    feature_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    sampling_size: float = 0.1,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """findObjects (hpp:723): returns (vote_positions [V,3],
    strengths [V], vote_point [V,3] — the keypoint that cast each vote).
    Vote strength = statistical_weight(class, cluster) *
    learned_weight(word); zero-strength votes are dropped. The cluster
    assignment runs on ``device`` (default CUDA)."""
    cloud = np.asarray(cloud, np.float32)
    normals = np.asarray(normals, np.float32)
    keep = simplify_cloud(cloud, sampling_size)
    pts, nn = cloud[keep], normals[keep]
    desc = _host(feature_fn(pts, nn))
    good = desc.sum(axis=1) >= _EPS
    pts, nn, desc = pts[good], nn[good], desc[good]
    if len(pts) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                np.zeros((0, 3), np.float32))

    dev = _device(device)
    assign = _nearest_cluster(torch.as_tensor(desc, device=dev),
                              torch.as_tensor(model.clusters_centers, device=dev)).cpu().numpy()
    rot = align_y_with_normal(nn)            # [P,3,3]

    vote_pos: List[np.ndarray] = []
    vote_str: List[np.ndarray] = []
    vote_src: List[np.ndarray] = []
    for i in range(len(pts)):
        members = np.asarray(model.clusters[int(assign[i])], np.int64)
        if members.size == 0:
            continue
        members = members[model.classes[members] == class_of_interest]
        if members.size == 0:
            continue
        # R^T * stored_dir (hpp:797 applies transform.transpose())
        d = np.einsum("kj,nj->nk", rot[i], model.directions_to_center[members])
        strength = (model.statistical_weights[class_of_interest,
                                              int(assign[i])]
                    * model.learned_weights[members])
        ok = strength > _EPS
        if not ok.any():
            continue
        vote_pos.append(pts[i][None, :] + d[ok])
        vote_str.append(strength[ok].astype(np.float32))
        vote_src.append(np.broadcast_to(pts[i], (int(ok.sum()), 3)))
    if not vote_pos:
        return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                np.zeros((0, 3), np.float32))
    return (np.concatenate(vote_pos), np.concatenate(vote_str),
            np.concatenate(vote_src).astype(np.float32))


def find_strongest_peaks(
    vote_positions: np.ndarray,
    vote_strengths: np.ndarray,
    class_id: int,
    non_maxima_radius: float,
    sigma: float,
    n_init: int = 100,
    max_shift_iters: int = 200,
) -> List[Tuple[np.ndarray, float]]:
    """ISMVoteList::findStrongestPeaks (hpp:119): ``n_init`` mean-shift
    chains started at votes spread uniformly by index, each iterated
    until the shift is below sigma/100 under the 3*sigma-truncated
    kernel strength*exp(-d^2/sigma^2) (shiftMean:234), then peak NMS by
    density. All chains advance together as one [n_init, V] kernel."""
    v = np.asarray(vote_positions, np.float32)
    w = np.asarray(vote_strengths, np.float32)
    if len(v) == 0:
        return []
    sigma = float(sigma)
    final_eps = sigma / 100.0
    idx = (np.arange(n_init, dtype=np.int64) * len(v)) // n_init
    centers = v[idx].copy()                       # [I,3]
    active = np.ones(len(centers), bool)
    for _ in range(max_shift_iters):
        if not active.any():
            break
        c = centers[active]                       # [A,3]
        d2 = np.sum((c[:, None, :] - v[None]) ** 2, axis=2)   # [A,V]
        kern = w[None] * np.exp(-d2 / (sigma * sigma))
        kern = np.where(d2 <= (3.0 * sigma) ** 2, kern, 0.0)
        den = kern.sum(axis=1)
        den = np.where(den < _EPS, 1.0, den)
        new_c = (kern @ v) / den[:, None]
        moved = np.linalg.norm(new_c - c, axis=1) > final_eps
        centers[active] = new_c
        pos = np.flatnonzero(active)
        active[pos[~moved]] = False

    # densities at the converged centers
    d2 = np.sum((centers[:, None, :] - v[None]) ** 2, axis=2)
    kern = w[None] * np.exp(-d2 / (sigma * sigma))
    kern = np.where(d2 <= (3.0 * sigma) ** 2, kern, 0.0)
    dens = kern.sum(axis=1)

    peaks: List[Tuple[np.ndarray, float]] = []
    flag = np.ones(len(centers), bool)
    for _ in range(len(centers)):
        if not flag.any():
            break
        i = int(np.argmax(np.where(flag, dens, -1.0)))
        if dens[i] < 0 or not flag[i]:
            break
        peaks.append((centers[i].copy(), float(dens[i])))
        near = np.linalg.norm(centers - centers[i], axis=1) < non_maxima_radius
        flag &= ~near
        flag[i] = False
    return peaks
