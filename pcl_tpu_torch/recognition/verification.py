"""Hypothesis verification: greedy, global and Papazov-style.

Counterpart of ``pcl_tpu/recognition/verification.py`` (PCL's hv/
greedy_verification.h, hv_go.h, hv_papazov.h). Every 1-NN is
``search.bruteforce.nn1``, which is kernel B1 on CUDA tensors.

- Greedy verification sorts the hypotheses by support (a stable sort, as
  ``jnp.argsort``) and accepts each whose explained points are mostly fresh,
  then marks them used. The reference marks with ``.at[pt].set(fresh)``;
  where several model points map to one scene point XLA keeps the last
  (ROADMAP C76). ``index_put_`` with duplicates is undefined on the card, so
  each scene point takes the ``fresh`` of the highest model index that maps
  to it (``scatter_reduce`` with ``amax``), which is the same, in any order.
- Global verification scores every single-bit flip of the active set at
  once (an ``[H, H, S]`` batch) and flips the best while it improves the
  cost by more than 1e-6, at most ``max_moves`` times, reading one flag back
  per move. Its ``[H, S]`` scene-to-model distances take one B1 call per
  hypothesis (their targets differ).
- Papazov verification thresholds support and penalty fractions per
  hypothesis, from one B1 call.
"""

from __future__ import annotations

import numpy as np
import torch

from pcl_tpu_torch.core.transforms import transform_points
from pcl_tpu_torch.search import bruteforce


def _sq(x: float) -> float:
    """``x ** 2`` in float32, as a traced float32 argument squares."""
    x32 = torch.tensor(x, dtype=torch.float32)
    return float(x32 * x32)


def _share(hits: torch.Tensor) -> torch.Tensor:
    """Row means of a bool ``[H, M]``, as XLA forms ``jnp.mean`` over a
    static length: the sum times the float32 reciprocal of ``M`` (XLA's CPU
    code divides by a constant so; true division differs in the last bit)."""
    return torch.sum(hits.to(torch.float32), dim=1) * float(np.float32(1.0 / hits.shape[1]))


def _model_to_scene(model_pts, transforms, scene_pts, scene_mask):
    """1-NN of every moved model point in the scene: ``(idx [H, M], d2 [H,
    M])``, one B1 call of ``H M`` queries."""
    H, M = transforms.shape[0], model_pts.shape[0]
    pts = transform_points(transforms, model_pts[None].expand(H, M, 3))
    idx, d2 = bruteforce.nn1(scene_pts, scene_mask, pts.reshape(H * M, 3))
    return idx.reshape(H, M), d2.reshape(H, M)


def last_writer(pt: torch.Tensor, size: int) -> torch.Tensor:
    """For each of ``size`` slots, the highest position ``j`` with ``pt[j]``
    equal to it (-1 where none): the write XLA keeps among duplicate indices
    of ``.at[pt].set(v)`` (ROADMAP C76)."""
    pos = torch.arange(pt.shape[0], device=pt.device)
    out = torch.full((size,), -1, dtype=torch.int64, device=pt.device)
    return out.scatter_reduce_(0, pt.long(), pos, "amax")


def greedy_hypothesis_verification(
    model_pts: torch.Tensor,       # [M, 3] model cloud (subsampled)
    transforms: torch.Tensor,      # [H, 4, 4] hypothesis poses
    hypothesis_ok: torch.Tensor,   # [H]
    scene_pts: torch.Tensor,       # [S, 3]
    scene_mask: torch.Tensor,      # [S]
    inlier_threshold: float = 0.01,
    support_fraction: float = 0.3,
) -> torch.Tensor:
    """``[H]`` bool acceptance mask."""
    H = transforms.shape[0]
    S = scene_pts.shape[0]
    idx, d2 = _model_to_scene(model_pts, transforms, scene_pts, scene_mask)
    explained = d2 <= _sq(inlier_threshold)
    support = _share(explained)
    order = torch.argsort(-support, stable=True)
    scene_used = torch.zeros(S, dtype=torch.bool, device=scene_pts.device)
    accept_sorted = []
    for hi in order.tolist():
        e = explained[hi]
        pt = torch.clamp(idx[hi], 0, S - 1)
        fresh = e & ~scene_used[pt]
        frac_fresh = torch.sum(fresh.to(torch.int32)) / torch.clamp(
            torch.sum(e.to(torch.int32)), min=1)
        accept = hypothesis_ok[hi] & (support[hi] >= support_fraction) & (frac_fresh > 0.5)
        last = last_writer(pt, S)
        mark = torch.where(last >= 0, fresh[torch.clamp(last, min=0)], False)
        scene_used = scene_used | (mark & accept)
        accept_sorted.append(accept)
    accept = torch.zeros(H, dtype=torch.bool, device=scene_pts.device)
    accept[order] = torch.stack(accept_sorted)
    return accept


def global_hypothesis_verification(
    model_pts: torch.Tensor,       # [M, 3] model cloud (subsampled)
    transforms: torch.Tensor,      # [H, 4, 4] hypothesis poses
    hypothesis_ok: torch.Tensor,   # [H]
    scene_pts: torch.Tensor,       # [S, 3]
    scene_mask: torch.Tensor,      # [S]
    inlier_threshold: float = 0.01,
    regularizer: float = 3.0,
    clutter_regularizer: float = 5.0,
    clutter_radius: float = 0.03,
    max_moves: int = 64,
) -> torch.Tensor:
    """Global-optimisation verification (pcl::GlobalHypothesesVerification):
    minimise ``-explained + regularizer duplicity + clutter + model
    outliers`` over the activation vector by steepest single-bit descent from
    all off. Returns the ``[H]`` bool acceptance mask."""
    H, M = transforms.shape[0], model_pts.shape[0]
    dev = scene_pts.device
    pts = transform_points(transforms, model_pts[None].expand(H, M, 3))
    all_m = torch.ones(M, dtype=torch.bool, device=dev)
    d2_sm = torch.stack([bruteforce.nn1(pts[h], all_m, scene_pts)[1] for h in range(H)])
    thr2 = _sq(inlier_threshold)
    w_explain = torch.where(scene_mask[None, :] & (d2_sm <= thr2), 1.0 - d2_sm / thr2, 0.0)
    explained_h = d2_sm <= thr2
    near_h = d2_sm <= _sq(clutter_radius)
    clutter_h = (near_h & ~explained_h & scene_mask[None, :]).to(torch.float32)
    _, md2 = bruteforce.nn1(scene_pts, scene_mask, pts.reshape(H * M, 3))
    outlier_h = _share(md2.reshape(H, M) > thr2)
    big_penalty = torch.where(hypothesis_ok, 0.0, 1e6)
    exp_f = explained_h.to(torch.float32)
    clutter_sum = torch.sum(clutter_h, dim=1)

    def cost(active):
        """Cost of each row of ``active [B, H]``: ``[B]``."""
        a = active.to(torch.float32)
        n_exp = a @ exp_f
        best_w = torch.amax(torch.where(active[:, :, None], w_explain[None], 0.0), dim=1)
        explained_val = torch.sum(best_w, dim=1)
        duplicity = torch.sum(torch.clamp(n_exp - 1.0, min=0.0), dim=1)
        clutter = a @ clutter_sum
        outliers = a @ outlier_h * M
        return (-explained_val + regularizer * duplicity + clutter_regularizer * clutter * 0.01
                + outliers * 0.05 + a @ big_penalty)

    eye = torch.eye(H, dtype=torch.bool, device=dev)
    active = torch.zeros(H, dtype=torch.bool, device=dev)
    cur = cost(active[None])[0]
    for _ in range(max_moves):
        cand = cost(active[None, :] ^ eye)
        best = torch.argmin(cand)
        if not bool(cand[best] < cur - 1e-6):
            break
        active = active ^ eye[best]
        cur = cand[best]
    return active & hypothesis_ok


def papazov_hypothesis_verification(
    model_pts: torch.Tensor,       # [M, 3] model cloud (subsampled)
    transforms: torch.Tensor,      # [H, 4, 4] hypothesis poses
    hypothesis_ok: torch.Tensor,   # [H]
    scene_pts: torch.Tensor,       # [S, 3]
    scene_mask: torch.Tensor,      # [S]
    inlier_threshold: float = 0.01,
    support_threshold: float = 0.1,
    penalty_threshold: float = 0.1,
) -> torch.Tensor:
    """Papazov-style filtering (hv_papazov.h): accept a hypothesis iff the
    share of its model points the scene explains is at least
    ``support_threshold`` and the share farther than twice the inlier
    threshold at most ``penalty_threshold``. ``[H]`` bool."""
    _, d2 = _model_to_scene(model_pts, transforms, scene_pts, scene_mask)
    support = _share(d2 <= _sq(inlier_threshold))
    penalty = _share(d2 > _sq(2.0 * inlier_threshold))
    return hypothesis_ok & (support >= support_threshold) & (penalty <= penalty_threshold)
