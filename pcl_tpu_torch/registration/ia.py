"""Feature-based initial alignment: SAC-IA and prerejective RANSAC.

Counterpart of ``pcl_tpu/registration/ia.py``. PCL's sequential iterations
become one batch of B hypotheses: each draws ``m`` source points and, for
each, one of the ``k`` target points most similar in feature space; Umeyama
fits a rigid transform per hypothesis; every hypothesis then transforms the
same random subset of S source points, and one flat 1-NN search of all
``B * S`` points against the target (kernel B1 on CUDA tensors) scores them.
SAC-IA keeps the least truncated error; the prerejective variant first drops
hypotheses whose matched triangles differ in edge-length ratio and keeps the
largest inlier fraction.

The JAX package draws with a ``key``, which the port cannot reproduce. Each
aligner is therefore its sampler (:func:`draw_ia_samples`: a
``torch.Generator``, seeded 0 on the source's device unless given) followed
by its deterministic core (:func:`sac_ia_core`, :func:`prerejective_core`),
which takes the feature candidates and the drawn ``sidx``, ``pick`` and
``sub``: given the JAX package's draws, the core gives its result.
"""

from __future__ import annotations

import importlib
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.core.transforms import transform_points
from pcl_tpu_torch.search import bruteforce

_ransac = importlib.import_module("pcl_tpu_torch.sac.ransac")

# feature_knn's distance matrix holds at most this many entries per chunk
_CHUNK_ELEMS = 1 << 25


def feature_knn(src_feat: torch.Tensor, src_mask: torch.Tensor, tgt_feat: torch.Tensor,
                tgt_mask: torch.Tensor, k: int) -> torch.Tensor:
    """``[N, D] x [M, D] -> [N, k]`` int32 indices of the most similar target
    features (L2 in descriptor space, the matmul identity, not clamped),
    ascending, the lower index first on a tie. A masked source row has only
    infinite distances and lists ``0 .. k-1``, as ``lax.top_k`` does. Source
    rows are taken in chunks, so ``[N, M]`` is never held whole."""
    t2 = torch.sum(tgt_feat * tgt_feat, dim=-1)
    step = max(1, _CHUNK_ELEMS // max(tgt_feat.shape[0], 1))
    parts = []
    for s in range(0, max(src_feat.shape[0], 1), step):
        sf = src_feat[s:s + step]
        d = torch.sum(sf * sf, dim=-1)[:, None] + t2[None, :] - 2.0 * (sf @ tgt_feat.T)
        d = torch.where(tgt_mask[None, :] & src_mask[s:s + step, None], d, math.inf)
        parts.append(bruteforce.smallest_k(d, k)[1])
    return torch.cat(parts).to(torch.int32)


class IAResult(NamedTuple):
    transform: torch.Tensor   # [4, 4]
    error: torch.Tensor       # f32 score of the best hypothesis
    valid: torch.Tensor       # bool


def draw_ia_samples(source_mask: torch.Tensor, n_hypotheses: int, sample_size: int,
                    k_corr: int, n_eval: int, gen: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The aligners' sampler: ``sidx [B, m]`` source points drawn among the
    valid ones, ``pick [B, m]`` which of the ``k_corr`` candidates each takes,
    and ``sub [S]`` the scoring subset of valid source points."""
    gen = _ransac.generator(source_mask.device, gen)
    sidx = _ransac.categorical(gen, source_mask, (n_hypotheses, sample_size)).to(torch.int32)
    pick = torch.randint(0, k_corr, (n_hypotheses, sample_size), generator=gen,
                         device=source_mask.device, dtype=torch.int32)
    sub = _ransac.categorical(gen, source_mask, (n_eval,)).to(torch.int32)
    return sidx, pick, sub


def _matched_samples(source: Cloud, target: Cloud, cand: torch.Tensor, sidx: torch.Tensor,
                     pick: torch.Tensor):
    """The sampled source points and the candidates they picked: ``[B, m, 3]``
    each."""
    sl = sidx.long()
    tidx = torch.gather(cand[sl], -1, pick.long()[..., None])[..., 0]
    return source.xyz[sl], target.xyz[torch.clamp(tidx.long(), 0, target.capacity - 1)]


def _batched_nn_d2(Ts: torch.Tensor, sub_xyz: torch.Tensor, tgt_xyz: torch.Tensor,
                   tgt_mask: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` squared distance of each subset point, moved by each
    hypothesis, to its nearest target: all ``B * S`` points in one flat 1-NN
    search."""
    p = transform_points(Ts, sub_xyz)
    B, S, _ = p.shape
    _, d2 = bruteforce.nn1(tgt_xyz, tgt_mask, p.reshape(B * S, 3).contiguous())
    return d2.reshape(B, S)


def _finite(Ts: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(Ts).all(dim=-1).all(dim=-1)


def sac_ia_scores(source: Cloud, target: Cloud, cand: torch.Tensor, sidx: torch.Tensor,
                  pick: torch.Tensor, sub: torch.Tensor, min_sample_distance: float = 0.0,
                  error_threshold: Optional[float] = None):
    """Every SAC-IA hypothesis: ``(transforms [B, 4, 4], errors [B])``, the
    error ``+inf`` where the sample is too tight or the fit not finite."""
    tx, tm = target.xyz, target.mask
    if error_threshold is None:
        # a data scale: a quarter of the target's bounding diagonal
        span = torch.amax(torch.where(tm[:, None], tx, -math.inf), dim=0) \
            - torch.amin(torch.where(tm[:, None], tx, math.inf), dim=0)
        thr = 0.25 * torch.linalg.vector_norm(span)
    else:
        thr = torch.tensor(float(np.float32(error_threshold)), device=tx.device)
    src_s, tgt_s = _matched_samples(source, target, cand, sidx, pick)
    m = src_s.shape[1]
    pd = torch.linalg.vector_norm(src_s[:, :, None, :] - src_s[:, None, :, :], dim=-1)
    iu = torch.ones((m, m), dtype=torch.bool, device=pd.device).triu(1)
    min_pd = torch.amin(torch.where(iu[None], pd, math.inf), dim=(1, 2))
    sample_ok = min_pd >= min_sample_distance
    Ts = geometry.umeyama(src_s, tgt_s, torch.ones(src_s.shape[:2], device=src_s.device))
    d2 = _batched_nn_d2(Ts, source.xyz[sub.long()], tx, tm)
    errs = torch.mean(torch.minimum(torch.sqrt(torch.clamp(d2, min=0.0)), thr), dim=1)
    return Ts, torch.where(sample_ok & _finite(Ts), errs, math.inf)


def sac_ia_core(source: Cloud, target: Cloud, cand: torch.Tensor, sidx: torch.Tensor,
                pick: torch.Tensor, sub: torch.Tensor, min_sample_distance: float = 0.0,
                error_threshold: Optional[float] = None) -> IAResult:
    """The deterministic part of :func:`sac_ia`: the least error wins (the
    first of equal errors)."""
    Ts, errs = sac_ia_scores(source, target, cand, sidx, pick, sub, min_sample_distance,
                             error_threshold)
    best = torch.argmin(errs)
    return IAResult(transform=Ts[best], error=errs[best], valid=torch.isfinite(errs[best]))


def sac_ia(source: Cloud, source_features: torch.Tensor, target: Cloud,
           target_features: torch.Tensor, *, gen: Optional[torch.Generator] = None,
           n_hypotheses: int = 512, k_corr: int = 10, sample_size: int = 3,
           min_sample_distance: float = 0.0, error_threshold: Optional[float] = None,
           n_eval: int = 512) -> IAResult:
    """SampleConsensusInitialAlignment: coarse alignment from features
    ``[capacity, D]`` row-aligned with the clouds. The error of a hypothesis
    is the mean NN distance of the subset, truncated at ``error_threshold``
    (by default a quarter of the target's bounding diagonal)."""
    cand = feature_knn(source_features, source.mask, target_features, target.mask, k_corr)
    sidx, pick, sub = draw_ia_samples(source.mask, n_hypotheses, sample_size, k_corr, n_eval, gen)
    return sac_ia_core(source, target, cand, sidx, pick, sub, min_sample_distance,
                       error_threshold)


def prerejective_scores(source: Cloud, target: Cloud, cand: torch.Tensor, sidx: torch.Tensor,
                        pick: torch.Tensor, sub: torch.Tensor, similarity_threshold: float = 0.9,
                        inlier_threshold: float = 0.05):
    """Every prerejective hypothesis: ``(transforms [B, 4, 4], inlier
    fractions [B])``, ``-inf`` where the triangles' edge ratios fail or the
    fit is not finite."""
    src_s, tgt_s = _matched_samples(source, target, cand, sidx, pick)

    def edges(p):
        e = torch.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 1], p[:, 0] - p[:, 2]], dim=1)
        return torch.linalg.vector_norm(e, dim=-1)

    es, et = edges(src_s), edges(tgt_s)
    ratio = torch.minimum(es, et) / torch.clamp(torch.maximum(es, et), min=1e-12)
    poly_ok = torch.all(ratio >= similarity_threshold, dim=1)
    Ts = geometry.umeyama(src_s, tgt_s, torch.ones(src_s.shape[:2], device=src_s.device))
    d2 = _batched_nn_d2(Ts, source.xyz[sub.long()], target.xyz, target.mask)
    gate = float(np.float32(inlier_threshold ** 2))
    score = torch.mean((d2 <= gate).to(torch.float32), dim=1)
    return Ts, torch.where(poly_ok & _finite(Ts), score, -math.inf)


def prerejective_core(source: Cloud, target: Cloud, cand: torch.Tensor, sidx: torch.Tensor,
                      pick: torch.Tensor, sub: torch.Tensor, similarity_threshold: float = 0.9,
                      inlier_threshold: float = 0.05) -> IAResult:
    """The deterministic part of :func:`prerejective_ransac`: the largest
    inlier fraction wins (the first of equal fractions)."""
    Ts, score = prerejective_scores(source, target, cand, sidx, pick, sub,
                                    similarity_threshold, inlier_threshold)
    best = torch.argmax(score)
    return IAResult(transform=Ts[best], error=1.0 - score[best],
                    valid=torch.isfinite(score[best]))


def prerejective_ransac(source: Cloud, source_features: torch.Tensor, target: Cloud,
                        target_features: torch.Tensor, *, gen: Optional[torch.Generator] = None,
                        n_hypotheses: int = 2048, k_corr: int = 5,
                        similarity_threshold: float = 0.9, inlier_threshold: float = 0.05,
                        n_eval: int = 1024) -> IAResult:
    """SampleConsensusPrerejective: 3-point hypotheses whose matched
    triangles keep every edge-length ratio above ``similarity_threshold``,
    scored by the fraction of the subset within ``inlier_threshold`` of the
    target."""
    cand = feature_knn(source_features, source.mask, target_features, target.mask, k_corr)
    sidx, pick, sub = draw_ia_samples(source.mask, n_hypotheses, 3, k_corr, n_eval, gen)
    return prerejective_core(source, target, cand, sidx, pick, sub, similarity_threshold,
                             inlier_threshold)
