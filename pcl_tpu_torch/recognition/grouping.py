"""Correspondence grouping: cluster model-to-scene matches into instances.

Counterpart of ``pcl_tpu/recognition/grouping.py`` (PCL's cg/
geometric_consistency.h and cg/hough_3d.h, and the per-instance
CorrespondenceRejectorSampleConsensus pass both apply).

- ``geometric_consistency_grouping``: two correspondences are consistent
  when their model-pair and scene-pair distances agree within ``gc_size``;
  the ``[C, C]`` consistency matrix is built at once and instances are taken
  greedily, each the largest consistent set left (the first on a tie). The
  pair distances are formed as XLA's CPU code forms ``jnp.linalg.norm``
  (``core.casts.norm3``, ROADMAP C75), so ``|dm - ds| < gc_size`` decides
  as in the reference.
- ``hough3d_grouping``: each correspondence votes for the model's reference
  point in the scene (through the local frames when given), splatted
  trilinearly into a hashed grid. The cells are cast as XLA casts
  (``core.casts.xla_int32``, C71); the hash multiplies in int32 and wraps,
  and ``abs(h) % size`` is a floor modulo as in the reference, so INT_MIN's
  bucket is the same. The splat adds with ``ops.segsum.add_rows``, which
  adds duplicates in index order on both devices (C28, C84): the peaks do
  not depend on a run.
- ``refine_grouping_sac``: per instance, RANSAC over its correspondences
  and Umeyama on the inliers. A sampler (:func:`draw_grouping_samples`, a
  ``torch.Generator``) and a core (:func:`refine_grouping_sac_core`) that
  takes the drawn indices (C17).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.casts import norm3, xla_int32
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.sac.models import RegistrationModel
from pcl_tpu_torch.sac.ransac import draw_samples, generator, ransac_core


class GroupingResult(NamedTuple):
    instances: torch.Tensor      # [I] bool: instance slot used
    members: torch.Tensor        # [I, C] bool: correspondences per instance
    transforms: torch.Tensor     # [I, 4, 4] model-to-scene rigid transforms


def _eye_like(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=x.device)


def geometric_consistency_grouping(
    model_pts: torch.Tensor,     # [C, 3] model keypoint per correspondence
    scene_pts: torch.Tensor,     # [C, 3] matched scene keypoint
    valid: torch.Tensor,         # [C]
    gc_size: float = 0.01,
    min_cluster_size: int = 3,
    max_instances: int = 4,
) -> GroupingResult:
    dm = norm3(model_pts[:, None, :] - model_pts[None, :, :])
    ds = norm3(scene_pts[:, None, :] - scene_pts[None, :, :])
    consistent = (torch.abs(dm - ds) < gc_size) & valid[:, None] & valid[None, :]
    used = torch.zeros_like(valid)
    oks, members, Ts = [], [], []
    for _ in range(max_instances):
        avail = consistent & ~used[None, :] & ~used[:, None]
        counts = torch.sum(avail.to(torch.int32), dim=1)
        seed = torch.argmax(counts)
        ok = counts[seed] >= min_cluster_size
        m = avail[seed] & ok
        T = geometry.umeyama(model_pts, scene_pts, m.to(torch.float32))
        oks.append(ok)
        members.append(m)
        Ts.append(torch.where(ok, T, _eye_like(T)))
        used = used | m
    return GroupingResult(torch.stack(oks), torch.stack(members), torch.stack(Ts))


def _cell_hash(c: torch.Tensor, table_size: int) -> torch.Tensor:
    """int32 hash of int32 cells, wrapping as XLA's int32 products do."""
    h = ((c[..., 0] * 73856093) ^ (c[..., 1] * 19349669) ^ (c[..., 2] * 83492791))
    return torch.abs(h) % table_size


def _splat(weights: torch.Tensor, h: torch.Tensor, table_size: int) -> torch.Tensor:
    """Sum of ``weights [C, B]`` per bucket ``h [C, B]`` (``table_size`` is
    the dump bucket), in index order."""
    out = torch.zeros(table_size + 1, dtype=torch.float32, device=weights.device)
    return add_rows(out, h.reshape(-1), weights.reshape(-1))[:table_size]


def hough3d_grouping(
    model_pts: torch.Tensor,       # [C, 3]
    scene_pts: torch.Tensor,       # [C, 3]
    valid: torch.Tensor,           # [C]
    model_centroid: torch.Tensor,  # [3] the model's reference point
    bin_size: float = 0.05,
    threshold: float = 3.0,
    max_instances: int = 4,
    table_size: int = 1 << 16,
    model_rf: Optional[torch.Tensor] = None,   # [C, 3, 3] rows = x/y/z axes
    scene_rf: Optional[torch.Tensor] = None,   # [C, 3, 3]
    corr_distance: Optional[torch.Tensor] = None,  # [C] descriptor distances
    use_interpolation: bool = True,
    use_distance_weight: bool = False,
) -> GroupingResult:
    """Hough voting for model instances. With ``model_rf``/``scene_rf`` the
    vote is the centroid offset in the model point's frame carried into the
    scene through the matched scene point's frame (hough_3d.hpp:138);
    without them the translation-only vote. ``use_interpolation`` splats
    over the 8 surrounding bins (HoughSpace3D::voteInt);
    ``use_distance_weight`` scales a vote by ``1 - d / d_max``."""
    C = model_pts.shape[0]
    dev = model_pts.device
    model_centroid = torch.as_tensor(model_centroid, dtype=torch.float32, device=dev)
    offset = model_centroid[None, :] - model_pts
    if model_rf is not None and scene_rf is not None:
        v_local = torch.einsum("cij,cj->ci", model_rf, offset)
        votes = scene_pts + torch.einsum("cji,cj->ci", scene_rf, v_local)
    else:
        votes = scene_pts + offset

    if use_distance_weight and corr_distance is not None:
        dmax = torch.clamp(torch.amax(torch.where(valid, corr_distance, 0.0)), min=1e-12)
        weight = 1.0 - corr_distance / dmax
    else:
        weight = torch.ones(C, dtype=torch.float32, device=dev)
    weight = torch.where(valid, weight, 0.0)

    g = votes / bin_size
    cell = xla_int32(torch.floor(g))                                 # [C, 3]
    frac = g - cell.to(torch.float32)
    if use_interpolation:
        side = torch.where(frac >= 0.5, 1, -1).to(torch.int32)
        w_central = 1.0 - torch.abs(frac - 0.5)
        w_neigh = 1.0 - w_central
        corners, cweights = [], []
        for bx in (0, 1):
            for by in (0, 1):
                for bz in (0, 1):
                    pick = torch.tensor([bx, by, bz], dtype=torch.int32, device=dev)
                    corners.append(cell + side * pick[None, :])
                    w = torch.where(pick[None, :] == 0, w_central, w_neigh)
                    cweights.append(w[:, 0] * w[:, 1] * w[:, 2])
        corners = torch.stack(corners, dim=1)                        # [C, 8, 3]
        cweights = torch.stack(cweights, dim=1) * weight[:, None]    # [C, 8]
    else:
        corners = cell[:, None, :]
        cweights = weight[:, None]

    h = _cell_hash(corners, table_size)
    h = torch.where(valid[:, None], h, table_size)
    counts = _splat(cweights, h, table_size)
    used = torch.zeros_like(valid)
    oks, members, Ts = [], [], []
    for _ in range(max_instances):
        peak = torch.argmax(counts)
        ok = counts[peak] >= threshold
        touches = torch.any((h == peak) & (cweights > 0), dim=1)
        m = touches & valid & ~used & ok
        T = geometry.umeyama(model_pts, scene_pts, m.to(torch.float32))
        oks.append(ok)
        members.append(m)
        Ts.append(torch.where(ok, T, _eye_like(T)))
        # retract the extracted voters' weight from every cell they touched
        retract = torch.where(m[:, None], cweights, 0.0)
        counts = torch.clamp(counts - _splat(retract, h, table_size), min=0.0)
        counts = counts.index_fill(0, peak.reshape(1), 0.0)
        used = used | m
    return GroupingResult(torch.stack(oks), torch.stack(members), torch.stack(Ts))


def draw_grouping_samples(result: GroupingResult, n_hypotheses: int = 4096,
                          gen: Optional[torch.Generator] = None) -> List[Optional[torch.Tensor]]:
    """The sampler of :func:`refine_grouping_sac`: for each used instance the
    ``[n_hypotheses, 3]`` RANSAC samples among its members (None for an
    unused slot)."""
    gen = generator(result.members.device, gen)
    used = result.instances.tolist()
    return [draw_samples(RegistrationModel(), result.members[i], n_hypotheses, gen=gen)[0]
            if used[i] else None for i in range(len(used))]


def refine_grouping_sac_core(model_pts: torch.Tensor, scene_pts: torch.Tensor,
                             result: GroupingResult, inlier_threshold: float,
                             samples: List[Optional[torch.Tensor]]) -> GroupingResult:
    """Per used instance, RANSAC's core on ``samples[i]`` over its members,
    the inliers kept (the cluster as it was where fewer than 3 remain) and
    the transform re-estimated on them."""
    members, transforms = [], []
    for i, idx in enumerate(samples):
        if idx is None:
            members.append(result.members[i])
            transforms.append(result.transforms[i])
            continue
        m = result.members[i]
        res = ransac_core(RegistrationModel(), model_pts, m, inlier_threshold, idx,
                          target_xyz=scene_pts)
        inl = res.inliers & m
        good = torch.sum(inl.to(torch.int32)) >= 3
        inl = torch.where(good, inl, m)
        members.append(inl)
        transforms.append(geometry.umeyama(model_pts, scene_pts, inl.to(torch.float32)))
    return GroupingResult(result.instances, torch.stack(members), torch.stack(transforms))


def refine_grouping_sac(model_pts, scene_pts, result: GroupingResult, inlier_threshold: float,
                        n_hypotheses: int = 4096,
                        gen: Optional[torch.Generator] = None) -> GroupingResult:
    """Per-instance RANSAC correspondence rejection and Umeyama re-estimate:
    the sampler, then the core."""
    dev = result.members.device
    model_pts = torch.as_tensor(model_pts, dtype=torch.float32, device=dev)
    scene_pts = torch.as_tensor(scene_pts, dtype=torch.float32, device=dev)
    samples = draw_grouping_samples(result, n_hypotheses, gen)
    return refine_grouping_sac_core(model_pts, scene_pts, result, inlier_threshold, samples)

