"""Correspondence rejection: PCL's rejector chain as functions that tighten
``Correspondences.valid``.

Counterpart of ``pcl_tpu/registration/rejection.py``. The random rejectors
are a sampler followed by a deterministic core that takes the drawn
indices (``reject_sample_consensus_core``, ``reject_polygon_core``).
"""

from __future__ import annotations

import importlib
import math
from typing import Optional

import numpy as np
import torch

from pcl_tpu_torch.registration.correspondence import Correspondences
from pcl_tpu_torch.sac.models import RegistrationModel

# ``sac.ransac`` is the function; the module by path
_ransac = importlib.import_module("pcl_tpu_torch.sac.ransac")

_I32_MAX = 2 ** 31 - 1


def reject_distance(c: Correspondences, max_distance: float) -> Correspondences:
    """CorrespondenceRejectorDistance."""
    return c._replace(valid=c.valid & (c.sqdist <= float(np.float32(max_distance ** 2))))


def reject_median_distance(c: Correspondences, factor: float = 1.0) -> Correspondences:
    """CorrespondenceRejectorMedianDistance: keep ``d^2 <= factor *
    median(d^2)`` over the valid pairs (PCL applies the factor to the squared
    distances). The median of an even count averages the two middle values."""
    med = _ransac.nanmedian(torch.where(c.valid, c.sqdist, math.nan))
    return c._replace(valid=c.valid & (c.sqdist <= factor * med))


def reject_trimmed(c: Correspondences, overlap_ratio: float = 0.5) -> Correspondences:
    """CorrespondenceRejectorTrimmed: keep the closest ``overlap_ratio`` of
    the valid pairs (ties in source order)."""
    n_valid = torch.sum(c.valid.to(torch.int32))
    k = torch.clamp((overlap_ratio * n_valid.to(torch.float32)).to(torch.int32), min=1)
    order = torch.argsort(torch.where(c.valid, c.sqdist, math.inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return c._replace(valid=c.valid & (rank < k))


def _segment_min(vals: torch.Tensor, ids: torch.Tensor, n_seg: int, identity) -> torch.Tensor:
    """``jax.ops.segment_min``: ids outside ``[0, n_seg)`` are dropped, an
    empty segment holds ``identity``."""
    out = vals.new_full((n_seg + 1,), identity)
    ids = torch.where((ids >= 0) & (ids < n_seg), ids, n_seg).long()
    return out.scatter_reduce(0, ids, vals, reduce="amin", include_self=True)[:n_seg]


def reject_one_to_one(c: Correspondences) -> Correspondences:
    """CorrespondenceRejectorOneToOne: each target index keeps only its
    closest source, the first in source order on a tie. As in the JAX
    package, segments are the source count plus one: a pair whose target
    index is past the source count finds another segment's minimum (the
    gather clamps) and is rejected."""
    n = c.index.shape[0]
    d2 = torch.where(c.valid, c.sqdist, math.inf)
    tgt = torch.where(c.valid, c.index, n).long()
    at = torch.clamp(tgt, max=n)
    best = _segment_min(d2, tgt, n + 1, math.inf)
    keep = c.valid & (d2 <= best[at])
    pos = torch.arange(n, device=c.index.device)
    first = _segment_min(torch.where(keep, pos, n), tgt, n + 1, _I32_MAX)
    return c._replace(valid=keep & (pos == first[at]))


def reject_surface_normals(c: Correspondences, src_normals: torch.Tensor,
                           tgt_normals: torch.Tensor, threshold: float = 0.7) -> Correspondences:
    """CorrespondenceRejectorSurfaceNormal: the normals' cosine must reach
    ``threshold``."""
    nt = tgt_normals[torch.clamp(c.index.long(), 0, tgt_normals.shape[0] - 1)]
    return c._replace(valid=c.valid & (torch.sum(src_normals * nt, dim=-1) >= threshold))


def _target_of_source(c: Correspondences, tgt_xyz: torch.Tensor) -> torch.Tensor:
    return tgt_xyz[torch.clamp(c.index.long(), 0, tgt_xyz.shape[0] - 1)]


def reject_sample_consensus_core(c: Correspondences, src_xyz: torch.Tensor,
                                 tgt_xyz: torch.Tensor, idx: torch.Tensor,
                                 inlier_threshold: float = 0.05) -> Correspondences:
    """The deterministic part of :func:`reject_sample_consensus`, from drawn
    correspondence triples ``idx [B, 3]``."""
    res = _ransac.ransac_core(RegistrationModel(), src_xyz, c.valid, inlier_threshold, idx,
                              target_xyz=_target_of_source(c, tgt_xyz))
    return c._replace(valid=c.valid & res.inliers)


def reject_sample_consensus(c: Correspondences, src_xyz: torch.Tensor, tgt_xyz: torch.Tensor,
                            inlier_threshold: float = 0.05, n_hypotheses: int = 512,
                            gen: Optional[torch.Generator] = None) -> Correspondences:
    """CorrespondenceRejectorSampleConsensus: RANSAC a rigid transform over
    the valid correspondences and keep its inliers."""
    idx, _ = _ransac.draw_samples(RegistrationModel(), c.valid, n_hypotheses, gen=gen)
    return reject_sample_consensus_core(c, src_xyz, tgt_xyz, idx, inlier_threshold)


def reject_polygon_core(c: Correspondences, src_xyz: torch.Tensor, tgt_xyz: torch.Tensor,
                        idx: torch.Tensor, similarity_threshold: float = 0.75) -> Correspondences:
    """The deterministic part of :func:`reject_polygon`, from drawn
    correspondence tuples ``idx [iterations, cardinality]``."""
    n = src_xyz.shape[0]
    il = idx.long()
    sp = src_xyz[il]
    tp = tgt_xyz[torch.clamp(c.index[il].long(), 0, tgt_xyz.shape[0] - 1)]

    def edge_lengths(p):
        return torch.linalg.vector_norm(torch.roll(p, -1, dims=1) - p, dim=-1)

    es, et = edge_lengths(sp), edge_lengths(tp)
    ratio = torch.minimum(es, et) / torch.clamp(torch.maximum(es, et), min=1e-12)
    ok_poly = torch.all(ratio >= similarity_threshold, dim=1)
    flat = il.reshape(-1)
    card = idx.shape[1]
    votes = torch.zeros(n, dtype=torch.int32, device=idx.device).index_add_(
        0, flat, ok_poly.to(torch.int32).repeat_interleave(card))
    trials = torch.zeros(n, dtype=torch.int32, device=idx.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    frac = votes / torch.clamp(trials, min=1)
    # a pair passes in at least half of its sampled polygons
    return c._replace(valid=c.valid & ((trials == 0) | (frac >= 0.5)))


def reject_polygon(c: Correspondences, src_xyz: torch.Tensor, tgt_xyz: torch.Tensor,
                   cardinality: int = 3, similarity_threshold: float = 0.75,
                   iterations: int = 256,
                   gen: Optional[torch.Generator] = None) -> Correspondences:
    """CorrespondenceRejectorPoly: random tuples of valid correspondences
    vote for pairs whose polygon edge-length ratios match."""
    gen = _ransac.generator(c.valid.device, gen)
    idx = _ransac.categorical(gen, c.valid, (iterations, cardinality)).to(torch.int32)
    return reject_polygon_core(c, src_xyz, tgt_xyz, idx, similarity_threshold)
