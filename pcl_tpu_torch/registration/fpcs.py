"""Featureless coarse alignment by congruent sets: FPCS, K-FPCS and 4PCS.

Counterpart of ``pcl_tpu/registration/fpcs.py`` (PCL's FPCSInitialAlignment
and KFPCSInitialAlignment). Hypotheses come from matching rigid-invariant
distance tuples between the clouds, without descriptors:

- :func:`fpcs_align`: batched 3-point bases; per base, random target pairs
  matching its first edge and, for each, every target point as the third
  vertex (one ``[B, P, M]`` comparison);
- :func:`kfpcs_align`: the same on ISS keypoints of both clouds;
- :func:`fpcs4_align`: coplanar 4-point bases, their diagonals'
  intersection ratios, and the target pairs best matching each diagonal's
  length over one ``[M, M]`` table;
- :func:`fpcs4_align_host`: 4PCS with the full pair table, its base draws on
  the host (``np.random.default_rng(seed)``, the same draws as the JAX
  package) and its pair table and congruent-set matching on the data's
  device, the intermediate points matched by the exact 1-NN (kernel B1).

Every hypothesis is an Umeyama fit; all are scored together by the
truncated error of a source subset (``ia._batched_nn_d2``: one B1 sweep of
all ``H x S`` moved points). The batched aligners are a sampler (a
``torch.Generator``, seeded 0 on the data's device unless given) and a
deterministic core that takes the drawn indices (ROADMAP C17). Top-k
selections are one stable sort, so the lower index wins a tie, as
``lax.top_k`` orders them (C8).
"""

from __future__ import annotations

import importlib
import math
from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.registration.ia import IAResult, _batched_nn_d2, _finite
from pcl_tpu_torch.search import bruteforce

_ransac = importlib.import_module("pcl_tpu_torch.sac.ransac")


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of length 3, summed in order
    (``x^2 + y^2 + z^2``, then the square root)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, descending, the lower index
    first among equals (``lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _span(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.where(mask[:, None], xyz, -math.inf), dim=0) \
        - torch.amin(torch.where(mask[:, None], xyz, math.inf), dim=0)


def _threshold(target: Cloud, error_threshold: Optional[float]) -> torch.Tensor:
    """The error truncation: given, or a quarter of the target's bounding
    diagonal."""
    if error_threshold is None:
        return 0.25 * torch.linalg.vector_norm(_span(target.xyz, target.mask))
    return torch.tensor(float(np.float32(error_threshold)), device=target.xyz.device)


def _errors(Ts: torch.Tensor, hyp_ok: torch.Tensor, source: Cloud, target: Cloud,
            sub: torch.Tensor, thr) -> torch.Tensor:
    """``[H]`` truncated mean subset error of every hypothesis, ``+inf``
    where it is not valid or not finite."""
    d2 = _batched_nn_d2(Ts, source.xyz[sub.long()], target.xyz, target.mask)
    errs = torch.mean(torch.minimum(torch.sqrt(torch.clamp(d2, min=0.0)), thr), dim=1)
    return torch.where(hyp_ok & _finite(Ts), errs, math.inf)


def _best(Ts: torch.Tensor, errs: torch.Tensor) -> IAResult:
    """The least error wins (the first of equal errors)."""
    best = torch.argmin(errs)
    return IAResult(transform=Ts[best], error=errs[best], valid=torch.isfinite(errs[best]))


# ---------------------------------------------------------------------------
# FPCS: 3-point bases
# ---------------------------------------------------------------------------

def draw_fpcs_samples(source_mask: torch.Tensor, target_mask: torch.Tensor, n_bases: int,
                      n_target_sub: int, pairs_per_base: int, n_eval: int,
                      gen: Optional[torch.Generator] = None):
    """:func:`fpcs_align`'s sampler: ``tsub_idx [M]`` target points,
    ``tri_idx [B, 3]`` source triangles, ``pij [B, P, 2]`` pairs of the
    target subsample and ``sub [S]`` the scoring subset."""
    gen = _ransac.generator(source_mask.device, gen)
    tsub_idx = _ransac.categorical(gen, target_mask, (n_target_sub,)).to(torch.int32)
    tri_idx = _ransac.categorical(gen, source_mask, (n_bases, 3)).to(torch.int32)
    pij = torch.randint(0, n_target_sub, (n_bases, pairs_per_base, 2), generator=gen,
                        device=source_mask.device, dtype=torch.int32)
    sub = _ransac.categorical(gen, source_mask, (n_eval,)).to(torch.int32)
    return tsub_idx, tri_idx, pij, sub


def fpcs_scores(source: Cloud, target: Cloud, tsub_idx: torch.Tensor, tri_idx: torch.Tensor,
                pij: torch.Tensor, sub: torch.Tensor, delta: float = 0.05,
                error_threshold: Optional[float] = None):
    """Every hypothesis of :func:`fpcs_align` on the drawn indices:
    ``(transforms [B P, 4, 4], errors [B P])``."""
    sx, tx = source.xyz, target.xyz
    B, P = pij.shape[:2]
    Tq = tx[tsub_idx.long()]                              # [M, 3]
    S = sx[tri_idx.long()]                                # [B, 3, 3]
    a = torch.linalg.vector_norm(S[:, 1] - S[:, 0], dim=-1)
    b = torch.linalg.vector_norm(S[:, 2] - S[:, 0], dim=-1)
    c = torch.linalg.vector_norm(S[:, 2] - S[:, 1], dim=-1)
    Pi = Tq[pij[..., 0].long()]                           # [B, P, 3]
    Pj = Tq[pij[..., 1].long()]
    pair_ok = torch.abs(torch.linalg.vector_norm(Pj - Pi, dim=-1) - a[:, None]) < delta
    d_ik = torch.linalg.vector_norm(Tq[None, None] - Pi[:, :, None], dim=-1)   # [B, P, M]
    d_jk = torch.linalg.vector_norm(Tq[None, None] - Pj[:, :, None], dim=-1)
    tri_ok = (torch.abs(d_ik - b[:, None, None]) < delta) \
        & (torch.abs(d_jk - c[:, None, None]) < delta) & pair_ok[:, :, None]
    kidx = torch.argmax(tri_ok.to(torch.int32), dim=-1)   # the first match
    has_match = torch.any(tri_ok, dim=-1)
    Pk = Tq[kidx]
    src_tri = S[:, None].expand(B, P, 3, 3).reshape(-1, 3, 3)
    dst_tri = torch.stack([Pi, Pj, Pk], dim=2).reshape(-1, 3, 3)
    Ts = geometry.umeyama(src_tri, dst_tri, torch.ones(src_tri.shape[:2], device=sx.device))
    return Ts, _errors(Ts, has_match.reshape(-1), source, target, sub,
                       _threshold(target, error_threshold))


def fpcs_core(source: Cloud, target: Cloud, tsub_idx: torch.Tensor, tri_idx: torch.Tensor,
              pij: torch.Tensor, sub: torch.Tensor, delta: float = 0.05,
              error_threshold: Optional[float] = None) -> IAResult:
    """The deterministic part of :func:`fpcs_align` on the drawn indices."""
    return _best(*fpcs_scores(source, target, tsub_idx, tri_idx, pij, sub, delta,
                              error_threshold))


def fpcs_align(source: Cloud, target: Cloud, *, delta: float = 0.05,
               gen: Optional[torch.Generator] = None, n_bases: int = 128,
               n_target_sub: int = 512, pairs_per_base: int = 8, n_eval: int = 512,
               error_threshold: Optional[float] = None) -> IAResult:
    """Coarse featureless alignment by congruent triangles; returns the best
    rigid transform. The congruence test is ``delta``-bounded; degenerate
    triangles simply score poorly."""
    draws = draw_fpcs_samples(source.mask, target.mask, n_bases, n_target_sub,
                              pairs_per_base, n_eval, gen)
    return fpcs_core(source, target, *draws, delta=delta, error_threshold=error_threshold)


def kfpcs_keypoints(source: Cloud, target: Cloud, salient_radius: float,
                    non_max_radius: Optional[float] = None) -> Tuple[Cloud, Cloud]:
    """The clouds :func:`kfpcs_align` hands to FPCS: each cloud with its
    density-weighted ISS keypoints as its mask, or both clouds unchanged when
    either has fewer than 8 keypoints (read back once)."""
    from pcl_tpu_torch.keypoints.iss import iss3d_keypoints

    if non_max_radius is None:
        non_max_radius = salient_radius * 0.5
    kp_s, _ = iss3d_keypoints(source, salient_radius, non_max_radius, density_weights=True)
    kp_t, _ = iss3d_keypoints(target, salient_radius, non_max_radius, density_weights=True)
    counts = torch.stack([torch.sum(kp_s.to(torch.int32)), torch.sum(kp_t.to(torch.int32))])
    if bool(torch.all(counts >= 8)):
        return Cloud(xyz=source.xyz, mask=kp_s), Cloud(xyz=target.xyz, mask=kp_t)
    return source, target


def kfpcs_align(source: Cloud, target: Cloud, *, salient_radius: float,
                non_max_radius: Optional[float] = None, delta: float = 0.05,
                gen: Optional[torch.Generator] = None, **fpcs_kw) -> IAResult:
    """Keypoint FPCS: :func:`fpcs_align` restricted to the density-weighted
    ISS keypoints of both clouds (``non_max_radius`` defaults to half the
    salient radius), or on the whole clouds when too few survive."""
    src, tgt = kfpcs_keypoints(source, target, salient_radius, non_max_radius)
    return fpcs_align(src, tgt, delta=delta, gen=gen, **fpcs_kw)


# ---------------------------------------------------------------------------
# 4PCS: coplanar 4-point bases, batched
# ---------------------------------------------------------------------------

_OS = 4           # oversampling of the wide-triangle draw
_K4 = 32          # candidates for the fourth point
_PAIRINGS = ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2))


def draw_fpcs4_samples(source_mask: torch.Tensor, target_mask: torch.Tensor, n_bases: int,
                       n_target_sub: int, n_eval: int, gen: Optional[torch.Generator] = None):
    """:func:`fpcs4_align`'s sampler: ``tri_idx [4 B, 3]`` candidate
    triangles, ``c4 [B, 32]`` candidate fourth points, ``tsub [M]`` target
    points and ``sub [S]`` the scoring subset."""
    gen = _ransac.generator(source_mask.device, gen)
    tri_idx = _ransac.categorical(gen, source_mask, (_OS * n_bases, 3)).to(torch.int32)
    c4 = _ransac.categorical(gen, source_mask, (n_bases, _K4)).to(torch.int32)
    tsub = _ransac.categorical(gen, target_mask, (n_target_sub,)).to(torch.int32)
    sub = _ransac.categorical(gen, source_mask, (n_eval,)).to(torch.int32)
    return tri_idx, c4, tsub, sub


def _seg_params(a, b, c, d):
    """Closest-point parameters ``(t1, t2)`` of segments ab and cd and the
    gap between the closest points (0.5 each where they are parallel)."""
    u, v, w = b - a, d - c, a - c
    uu, vv = torch.sum(u * u, -1), torch.sum(v * v, -1)
    uv, uw, vw = torch.sum(u * v, -1), torch.sum(u * w, -1), torch.sum(v * w, -1)
    den = uu * vv - uv * uv
    ok = torch.abs(den) > 1e-12
    dd = torch.clamp(den, min=1e-12)
    t1 = torch.where(ok, (uv * vw - vv * uw) / dd, 0.5)
    t2 = torch.where(ok, (uu * vw - uv * uw) / dd, 0.5)
    gap = torch.linalg.vector_norm((a + t1[..., None] * u) - (c + t2[..., None] * v), dim=-1)
    return t1, t2, gap


def fpcs4_scores(source: Cloud, target: Cloud, tri_idx: torch.Tensor, c4: torch.Tensor,
                 tsub: torch.Tensor, sub: torch.Tensor, *, delta: float = 0.05,
                 overlap: float = 0.5, pairs_per_base: int = 256, n_hyp: int = 1024,
                 error_threshold: Optional[float] = None):
    """Every hypothesis of :func:`fpcs4_align` on the drawn indices:
    ``(transforms [n_hyp, 4, 4], errors [n_hyp])``."""
    sx, sm = source.xyz, source.mask
    n_bases = c4.shape[0]
    dev = sx.device
    # --- source bases: the widest triangles within the overlap span, and the
    # most coplanar fourth point not too close to them
    span = _span(sx, sm)
    target_span = float(np.float32(overlap)) * torch.linalg.vector_norm(span) * 0.6
    Tri = sx[tri_idx.long()]                              # [4B, 3, 3]
    e01 = torch.linalg.vector_norm(Tri[:, 1] - Tri[:, 0], dim=-1)
    e02 = torch.linalg.vector_norm(Tri[:, 2] - Tri[:, 0], dim=-1)
    e12 = torch.linalg.vector_norm(Tri[:, 2] - Tri[:, 1], dim=-1)
    min_edge = torch.minimum(torch.minimum(e01, e02), e12)
    max_edge = torch.maximum(torch.maximum(e01, e02), e12)
    _, keep = _top_k(torch.where(max_edge <= target_span, min_edge, -max_edge), n_bases)
    tri = tri_idx.long()[keep]                            # [B, 3]
    P0, P1, P2 = sx[tri[:, 0]], sx[tri[:, 1]], sx[tri[:, 2]]
    C4 = sx[c4.long()]                                    # [B, K4, 3]
    nrm = torch.linalg.cross(P1 - P0, P2 - P0)
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-12)
    dplane = torch.abs(torch.einsum("bkj,bj->bk", C4 - P0[:, None], nrm))
    dmin = torch.minimum(torch.minimum(torch.linalg.vector_norm(C4 - P0[:, None], dim=-1),
                                       torch.linalg.vector_norm(C4 - P1[:, None], dim=-1)),
                         torch.linalg.vector_norm(C4 - P2[:, None], dim=-1))
    cop_score = dplane + torch.where(dmin < 0.05 * target_span, 1e6, 0.0)
    P3 = C4[torch.arange(n_bases, device=dev), torch.argmin(cop_score, dim=1)]
    quads = torch.stack([P0, P1, P2, P3], dim=1)          # [B, 4, 3]
    # the pairing into two crossing segments whose closest points are nearest
    tt1, tt2, gaps = [], [], []
    for (i, j, k, l) in _PAIRINGS:
        t1, t2, gap = _seg_params(quads[:, i], quads[:, j], quads[:, k], quads[:, l])
        inside = (t1 > 0.05) & (t1 < 0.95) & (t2 > 0.05) & (t2 < 0.95)
        tt1.append(t1)
        tt2.append(t2)
        gaps.append(torch.where(inside, gap, math.inf))
    gaps = torch.stack(gaps, dim=1)                       # [B, 3]
    best_pair = torch.argmin(gaps, dim=1)
    pick = torch.tensor(_PAIRINGS, device=dev)[best_pair]  # [B, 4]
    ar = torch.arange(n_bases, device=dev)
    A, Bp, Cc, D = (quads[ar, pick[:, m]] for m in range(4))
    r1 = torch.stack(tt1, 1)[ar, best_pair]
    r2 = torch.stack(tt2, 1)[ar, best_pair]
    d1 = torch.linalg.vector_norm(Bp - A, dim=-1)
    d2len = torch.linalg.vector_norm(D - Cc, dim=-1)
    base_ok = torch.isfinite(torch.amin(gaps, dim=1))
    # --- target pair table: every directed pair of the subsample
    Q = target.xyz[tsub.long()]                           # [M, 3]
    M = Q.shape[0]
    plen = torch.linalg.vector_norm(Q[:, None, :] - Q[None, :, :], dim=-1)
    plen.fill_diagonal_(math.inf)
    flat_len = plen.reshape(-1)
    K = pairs_per_base

    def pairs_for(dlen):
        val, idx = _top_k(-torch.abs(flat_len[None, :] - dlen[:, None]), K)
        return idx, -val < delta

    idx1, ok1 = pairs_for(d1)
    idx2, ok2 = pairs_for(d2len)
    i1, j1 = idx1 // M, idx1 % M
    i2, j2 = idx2 // M, idx2 % M
    E1 = Q[i1] + r1[:, None, None] * (Q[j1] - Q[i1])      # [B, K, 3]
    E2 = Q[i2] + r2[:, None, None] * (Q[j2] - Q[i2])
    # congruency: every e1 against every e2 of the base
    gap12 = torch.linalg.vector_norm(E1[:, :, None, :] - E2[:, None, :, :], dim=-1)
    gap12 = torch.where(ok1[:, :, None] & ok2[:, None, :] & base_ok[:, None, None],
                        gap12, math.inf)                  # [B, K, K]
    bestgap, best2 = torch.min(gap12, dim=2)              # the first e2 at the minimum
    flatgap = bestgap.reshape(-1)
    _, hid = _top_k(-flatgap, n_hyp)
    hb, hk = hid // K, hid % K
    h2 = best2[hb, hk]
    hyp_ok = torch.isfinite(flatgap[hid]) & (flatgap[hid] < delta)
    src4 = torch.stack([A[hb], Bp[hb], Cc[hb], D[hb]], dim=1)   # [H, 4, 3]
    dst4 = torch.stack([Q[i1[hb, hk]], Q[j1[hb, hk]], Q[i2[hb, h2]], Q[j2[hb, h2]]], dim=1)
    Ts = geometry.umeyama(src4, dst4, torch.ones(src4.shape[:2], device=dev))
    thr = 0.25 * torch.linalg.vector_norm(span) if error_threshold is None \
        else torch.tensor(float(np.float32(error_threshold)), device=dev)
    return Ts, _errors(Ts, hyp_ok, source, target, sub, thr)


def fpcs4_core(source: Cloud, target: Cloud, tri_idx: torch.Tensor, c4: torch.Tensor,
               tsub: torch.Tensor, sub: torch.Tensor, **kw) -> IAResult:
    """The deterministic part of :func:`fpcs4_align` on the drawn indices
    (the keywords of :func:`fpcs4_scores`)."""
    return _best(*fpcs4_scores(source, target, tri_idx, c4, tsub, sub, **kw))


def fpcs4_align(source: Cloud, target: Cloud, *, delta: float = 0.05, overlap: float = 0.5,
                gen: Optional[torch.Generator] = None, n_bases: int = 64,
                n_target_sub: int = 384, pairs_per_base: int = 256, n_hyp: int = 1024,
                n_eval: int = 384, error_threshold: Optional[float] = None) -> IAResult:
    """4-points-congruent-sets coarse alignment, batched: ``n_bases``
    coplanar wide bases (edges up to ``0.6 overlap`` of the source's
    diameter), the ``pairs_per_base`` directed target pairs best matching
    each diagonal, their intermediate points matched within the base, and
    the ``n_hyp`` most congruent sets as Umeyama hypotheses. The error
    truncation defaults to a quarter of the source's bounding diagonal."""
    draws = draw_fpcs4_samples(source.mask, target.mask, n_bases, n_target_sub, n_eval, gen)
    return fpcs4_core(source, target, *draws, delta=delta, overlap=overlap,
                      pairs_per_base=pairs_per_base, n_hyp=n_hyp,
                      error_threshold=error_threshold)


# ---------------------------------------------------------------------------
# 4PCS with the full pair table
# ---------------------------------------------------------------------------

def _seg_params_host(a, b, c, d):
    u, v, w = b - a, d - c, a - c
    uu, vv = u @ u, v @ v
    uv, uw, vw = u @ v, u @ w, v @ w
    den = uu * vv - uv * uv
    if abs(den) < 1e-12:
        return None
    t1 = (uv * vw - vv * uw) / den
    t2 = (uu * vw - uv * uw) / den
    return t1, t2, np.linalg.norm((a + t1 * u) - (c + t2 * v))


def _host_base(rng, sxyz: np.ndarray, max_base: float, too_close: float):
    """One wide coplanar base drawn on the host as the JAX package draws it:
    ``(p0, p1, p2, p3, r1, r2)`` with (p0, p1) x (p2, p3) the diagonals, or
    None."""
    ns = len(sxyz)
    best = None
    for _ in range(20):
        i, j, k = rng.choice(ns, 3, replace=False)
        a, b, c = sxyz[i], sxyz[j], sxyz[k]
        e = [np.linalg.norm(b - a), np.linalg.norm(c - a), np.linalg.norm(c - b)]
        if min(e) < too_close or max(e) > max_base:
            continue
        if best is None or min(e) > best[0]:
            best = (min(e), a, b, c)
    if best is None:
        return None
    _, a, b, c = best
    nrm = np.cross(b - a, c - a)
    nn = np.linalg.norm(nrm)
    if nn < 1e-9:
        return None
    nrm /= nn
    c4 = sxyz[rng.choice(ns, 64, replace=ns < 64)]
    dpl = np.abs((c4 - a) @ nrm)
    dmin = np.minimum.reduce([np.linalg.norm(c4 - p, axis=1) for p in (a, b, c)])
    dpl[dmin < too_close] = np.inf
    d = c4[int(np.argmin(dpl))]
    bestp = None
    for (p0, p1, p2, p3) in ((a, b, c, d), (a, c, b, d), (a, d, b, c)):
        sp = _seg_params_host(p0, p1, p2, p3)
        if sp is None:
            continue
        t1, t2, gap = sp
        if 0.0 < t1 < 1.0 and 0.0 < t2 < 1.0 and (bestp is None or gap < bestp[0]):
            bestp = (gap, p0, p1, p2, p3, t1, t2)
    return None if bestp is None else bestp[1:]


def fpcs4_align_host(source: Cloud, target: Cloud, *, delta: float = 0.05,
                     overlap: float = 0.5, key=None, n_bases: int = 64,
                     max_sets_per_base: int = 64, n_eval: int = 384,
                     seed: int = 0) -> IAResult:
    """4PCS with PCL's full pair-table search. Per base: a wide coplanar base
    bounded by ``2 overlap`` of the source's diameter; all directed target
    pairs within ``2 delta`` of each diagonal's length; their intermediate
    points e2 matched to the nearest e1 (kernel B1 on CUDA tensors) within
    ``2 delta``; at most ``max_sets_per_base`` congruent sets, each an
    Umeyama fit kept where its 4-point MSE is at most ``(2 delta)^2``; the
    least truncated subset error wins.

    The base and subset draws are the JAX package's own
    (``np.random.default_rng(seed)`` on the host, source points on the host);
    the ``[M, M]`` pair table over the valid target points, its ``nonzero``
    lists (row-major, as numpy's) and the matching stay on the target's
    device in float32, as the reference forms them from float32 points. Two
    host reads a base: whether both pair lists are non-empty, and the hits
    the draw needs. ``key`` is accepted and unused, as in the JAX package."""
    rng = np.random.default_rng(seed)
    dev = target.xyz.device
    sxyz = source.xyz[source.mask].cpu().numpy()
    txyz = target.xyz[target.mask]
    ns, M = len(sxyz), txyz.shape[0]
    diam = float(np.linalg.norm(sxyz.max(0) - sxyz.min(0)))
    max_base = 2.0 * overlap * diam
    too_close = 0.1 * max_base
    max_pair_diff = 2.0 * delta
    coincid = 2.0 * delta
    max_mse = (2.0 * delta) ** 2
    plen = _norm(txyz[:, None, :] - txyz[None, :, :])
    plen.fill_diagonal_(math.inf)

    cands_src, cands_dst = [], []
    for _ in range(n_bases):
        base = _host_base(rng, sxyz, max_base, too_close)
        if base is None:
            continue
        p0, p1, p2, p3, r1, r2 = base
        d1 = np.linalg.norm(p1 - p0)
        d2l = np.linalg.norm(p3 - p2)
        ii1, jj1 = torch.nonzero(torch.abs(plen - float(d1)) < max_pair_diff, as_tuple=True)
        ii2, jj2 = torch.nonzero(torch.abs(plen - float(d2l)) < max_pair_diff, as_tuple=True)
        if len(ii1) == 0 or len(ii2) == 0:
            continue
        r1f, r2f = float(np.float32(r1)), float(np.float32(r2))
        e1 = txyz[ii1] + r1f * (txyz[jj1] - txyz[ii1])
        e2 = txyz[ii2] + r2f * (txyz[jj2] - txyz[ii2])
        idq, d2q = bruteforce.nn1(e1, torch.ones(e1.shape[0], dtype=torch.bool, device=dev), e2)
        hit = torch.sqrt(torch.clamp(d2q, min=0.0)) < coincid
        hit_ids = torch.nonzero(hit)[:, 0].cpu().numpy()
        if len(hit_ids) == 0:
            continue
        if len(hit_ids) > max_sets_per_base:
            hit_ids = rng.choice(hit_ids, max_sets_per_base, replace=False)
        hits = torch.from_numpy(np.ascontiguousarray(hit_ids)).to(dev)
        m1 = idq[hits].long()
        cands_src.append(np.stack([np.broadcast_to(p, (len(hit_ids), 3))
                                   for p in (p0, p1, p2, p3)], axis=1))
        cands_dst.append(torch.stack([txyz[ii1[m1]], txyz[jj1[m1]], txyz[ii2[hits]],
                                      txyz[jj2[hits]]], dim=1))
    if not cands_src:
        return IAResult(transform=torch.eye(4, device=dev),
                        error=torch.tensor(math.inf, device=dev),
                        valid=torch.zeros((), dtype=torch.bool, device=dev))
    src4 = torch.from_numpy(np.concatenate(cands_src).astype(np.float32)).to(dev)
    dst4 = torch.cat(cands_dst)
    Ts = geometry.umeyama(src4, dst4, torch.ones(src4.shape[:2], device=dev))
    # the base's own fit (PCL's validateMatch, max_mse)
    fit = torch.einsum("hij,hkj->hki", Ts[:, :3, :3], src4) + Ts[:, None, :3, 3]
    mse = torch.mean(torch.sum((fit - dst4) ** 2, dim=-1), dim=1)
    sub = torch.from_numpy(rng.choice(ns, min(n_eval, ns), replace=False)).to(dev)
    src_live = Cloud(xyz=torch.from_numpy(sxyz).to(dev),
                     mask=torch.ones(ns, dtype=torch.bool, device=dev))
    tgt_live = Cloud(xyz=txyz, mask=torch.ones(M, dtype=torch.bool, device=dev))
    thr = torch.tensor(float(np.float32(0.25 * diam)), device=dev)
    return _best(Ts, _errors(Ts, mse <= max_mse, src_live, tgt_live, sub, thr))
