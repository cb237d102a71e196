"""Supervoxel clustering (VCCS).

Counterpart of ``pcl_tpu/segmentation/supervoxel.py`` (PCL's
SupervoxelClustering, re-designed in the JAX package): seeds are the points
``filters.uniform_sample`` keeps at ``seed_resolution`` (the first
``max_seeds``), then ``iterations`` rounds of assignment and update. Each
point joins the best of its ``k_seeds`` nearest seeds (brute kNN) within
twice the seed resolution by

    D = wc |rgb - rgb_s| + ws |p - p_s| / seed_resolution + wn (1 - |n . n_s|),

and each seed moves to the mean of its points, its normal to their
normalised mean normal and its colour to their mean colour. The sums are
``index_put_`` with accumulation (the JAX package's unsorted
``segment_sum``), which adds in index order, so the card repeats bitwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, ATTR_RGB, Cloud
from pcl_tpu_torch.features.shot import _f32
from pcl_tpu_torch.filters.voxel_grid import uniform_sample
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.search import bruteforce


class SupervoxelResult(NamedTuple):
    labels: torch.Tensor        # [N] int32 supervoxel id (-1 unassigned)
    centers: torch.Tensor       # [S, 3] supervoxel centroids
    center_valid: torch.Tensor  # [S]
    normals: torch.Tensor       # [S, 3] mean normals


def supervoxel_clustering(cloud: Cloud, seed_resolution: float, color_importance: float = 0.2,
                          spatial_importance: float = 0.4, normal_importance: float = 1.0,
                          max_seeds: int = 512, k_seeds: int = 8, iterations: int = 8
                          ) -> SupervoxelResult:
    """Supervoxels of a cloud (normals and ``rgb`` enter the distance when
    the cloud has them)."""
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    normals = cloud.attrs.get(ATTR_NORMAL)
    rgb = cloud.attrs.get(ATTR_RGB)
    S = max_seeds
    seeded = uniform_sample(cloud, seed_resolution)
    centers, cvalid = seeded.xyz[:S], seeded.mask[:S]
    res = _f32(seed_resolution)
    twice = np.float32(2.0) * np.float32(seed_resolution)
    gate = float(twice * twice)

    def assign(centers, cvalid, cnormals, crgb):
        idx, d2, valid = bruteforce.knn(centers, cvalid, xyz, k_seeds)
        idxc = torch.clamp(idx.long(), 0, S - 1)
        D = _f32(spatial_importance) * torch.sqrt(torch.clamp(d2, min=0.0)) / res
        if normals is not None:
            dn = 1.0 - torch.abs(torch.einsum("ni,nki->nk", normals, cnormals[idxc]))
            D = D + _f32(normal_importance) * dn
        if rgb is not None:
            dc = torch.linalg.vector_norm(rgb[:, None, :] - crgb[idxc], dim=-1)
            D = D + _f32(color_importance) * dc
        D = torch.where(valid & (d2 <= gate), D, math.inf)
        dmin, best = torch.min(D, dim=1)             # the first column at the minimum
        lab = torch.gather(idxc, 1, best[:, None])[:, 0]
        return torch.where(torch.isfinite(dmin) & mask, lab, -1)

    def seg_mean(values, lab, fallback):
        w = (lab >= 0).to(torch.float32)
        labc = torch.where(lab >= 0, lab, S)
        s = add_rows(torch.zeros((S + 1, values.shape[1]), device=dev), labc,
                     values * w[:, None])[:S]
        c = add_rows(torch.zeros(S + 1, device=dev), labc, w)[:S]
        return torch.where(c[:, None] > 0, s / torch.clamp(c, min=1.0)[:, None], fallback)

    zero3 = torch.zeros((S, 3), device=dev)
    cnormals = normals[:S] if normals is not None else zero3
    crgb = rgb[:S] if rgb is not None else zero3
    labels = torch.full((cloud.capacity,), -1, dtype=torch.int64, device=dev)
    for _ in range(iterations):
        labels = assign(centers, cvalid, cnormals, crgb)
        new_centers = seg_mean(xyz, labels, centers)
        if normals is not None:
            nn = seg_mean(normals, labels, cnormals)
            cnormals = nn / torch.clamp(torch.linalg.vector_norm(nn, dim=-1, keepdim=True),
                                        min=1e-12)
        if rgb is not None:
            crgb = seg_mean(rgb, labels, crgb)
        centers = new_centers
    return SupervoxelResult(labels=labels.to(torch.int32), centers=centers, center_valid=cvalid,
                            normals=cnormals)
