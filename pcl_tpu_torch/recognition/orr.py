"""ObjRecRANSAC-style recognition, trimmed ICP, distance and mask maps.

Counterpart of ``pcl_tpu/recognition/orr.py`` (PCL's ransac_based/
trimmed_icp.h, obj_rec_ransac.h, model_library.h, distance_map.h,
mask_map.h).

- ``trimmed_icp`` fits only the closest ``trim_fraction`` of the
  correspondences each iteration (a threshold at that quantile), one B1 call
  and one flag read back per iteration. The trimmed MSE selects where the
  weight is zero, since an unmatched point's distance is ``+inf`` (ROADMAP
  C7).
- ObjRecRANSAC hypotheses come from a sampler (:func:`draw_orr_samples`:
  the first point of each scene pair, drawn with weight ``mask + 1e-9``; its
  partner, uniform among the points at the pair distance, or among all
  points where there is none; 512 model pair starts) and a core
  (:func:`_orr_hypotheses`) that takes the draws (C17). Support
  (:func:`_orr_support`) is one B1 call of ``H M`` queries: every query's
  result is the one the reference's per-hypothesis sweep gives.
- ``distance_map`` is exact: the nearest marked row in each column by
  cumulative maxima of row indices, then the minimum over columns of
  ``dy^2 + dx^2``, the root correctly rounded.
- ``sample_oriented_point_pairs`` and ``pair_feature_hash_table`` are a
  sampler and a core as well; the hash table's bins are cast as XLA casts
  (``core.casts.xla_int32``) and then clipped, so NaN lands on bin 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core import geometry, transforms
from pcl_tpu_torch.core.casts import norm3, xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.sac.ransac import generator
from pcl_tpu_torch.search import bruteforce

_MODEL_PAIRS = 512


class TrimmedICPResult(NamedTuple):
    transform: torch.Tensor   # [4, 4]
    mse: torch.Tensor         # trimmed mean squared error
    iterations: int


def _f32(x: float) -> float:
    return float(np.float32(x))


def trimmed_icp(
    source: Cloud,
    target: Cloud,
    trim_fraction: float = 0.4,
    max_iterations: int = 30,
    tolerance: float = 1e-7,
    init: Optional[torch.Tensor] = None,
) -> TrimmedICPResult:
    """Align ``source`` to ``target`` on the closest ``trim_fraction`` of
    the points each iteration (trimmed_icp.h align)."""
    sx, sm = source.xyz, source.mask
    tx, tm = target.xyz, target.mask
    dev = sx.device
    T = torch.eye(4, dtype=torch.float32, device=dev) if init is None else \
        torch.as_tensor(init, dtype=torch.float32, device=dev)
    n_valid = torch.clamp(torch.sum(sm.to(torch.int32)), min=1)
    k = torch.clamp((torch.tensor(_f32(trim_fraction), device=dev)
                     * n_valid.to(torch.float32)).to(torch.int32), min=3)
    kth = torch.clamp(k - 1, 0, sx.shape[0] - 1).long()
    prev = torch.tensor(math.inf, device=dev)
    mse = prev
    it = 0
    while it < max_iterations:
        cur = transforms.transform_points(T, sx)
        idx, d2 = bruteforce.nn1(tx, tm, cur)
        d2 = torch.where(sm & (idx >= 0), d2, math.inf)
        thr = torch.sort(d2).values[kth]
        keep = (d2 <= thr) & torch.isfinite(d2)
        w = keep.to(torch.float32)
        tgt = tx[torch.clamp(idx, 0, tx.shape[0] - 1).long()]
        T = geometry.umeyama(cur, tgt, w) @ T
        mse = torch.sum(torch.where(keep, d2, 0.0)) / torch.clamp(torch.sum(w), min=1.0)
        delta = torch.abs(prev - mse)
        prev = mse
        it += 1
        if not bool(delta > _f32(tolerance)):
            break
    return TrimmedICPResult(T, mse, it)


def _categorical_rows(gen, weights: torch.Tensor) -> torch.Tensor:
    """One index per row of ``weights [R, N]`` in proportion to it, uniform
    over the row where it is all zero (``categorical`` over logits of 0 and
    -1e9)."""
    w = weights.to(torch.float32)
    w = w + (torch.sum(w, dim=1, keepdim=True) == 0).to(torch.float32)
    idx = torch.multinomial(w.to(gen.device), 1, replacement=True, generator=gen)[:, 0]
    return idx.to(weights.device)


def _first_points(gen, mask: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` draws with weight ``mask + 1e-9`` (``categorical`` over
    ``log(mask + 1e-9)``): an invalid point keeps about 1e-9 of the odds."""
    w = (mask.to(torch.float32) + 1e-9).to(gen.device)
    return torch.multinomial(w, n, replacement=True, generator=gen).to(mask.device)


def _partners(xyz: torch.Tensor, mask: torch.Tensor, i1: torch.Tensor, pair_dist: float,
              dist_tol: float) -> torch.Tensor:
    """``[P, N]`` bool: point ``j`` lies at the pair distance from ``i1``."""
    d = norm3(xyz[None, :, :] - xyz[i1.long()][:, None, :])
    return mask[None, :] & (torch.abs(d - _f32(pair_dist)) < _f32(dist_tol))


def _draw_pairs(gen, xyz, mask, n, pair_dist, dist_tol, rows: int = 256):
    i1 = _first_points(gen, mask, n)
    i2 = torch.cat([_categorical_rows(gen, _partners(xyz, mask, i1[s:s + rows], pair_dist,
                                                     dist_tol))
                    for s in range(0, n, rows)])
    return i1, i2


def draw_orr_samples(scene: Cloud, model: Cloud, pair_dist: float, dist_tol: float,
                     n_hypotheses: int, gen: Optional[torch.Generator] = None):
    """The sampler of ObjRecRANSAC: ``(i1 [H], i2 [H])`` scene pairs and
    ``mp1 [512]`` model pair starts, int64."""
    gen = generator(scene.xyz.device, gen)
    i1, i2 = _draw_pairs(gen, scene.xyz, scene.mask, n_hypotheses, pair_dist, dist_tol)
    mp1 = torch.randint(0, model.xyz.shape[0], (_MODEL_PAIRS,), generator=gen,
                        device=gen.device).to(scene.xyz.device)
    return i1, i2, mp1


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _acos(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def _ppf_feat(p1, n1, p2, n2):
    dv = p2 - p1
    dn = norm3(dv)[..., None] + 1e-12
    u = dv / dn
    return torch.stack([dn[..., 0], _acos(_dot(n1, u)), _acos(_dot(n2, u)), _acos(_dot(n1, n2))],
                       dim=-1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (norm3(x)[..., None] + 1e-12)


def _pair_frame(p1, p2, n1):
    x = _unit(p2 - p1)
    z = _unit(n1 - _dot(n1, x)[..., None] * x)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def _orr_hypotheses(i1, i2, mp1, sxyz, smask, snormals, mxyz, mmask, mnormals,
                    pair_dist: float, dist_tol: float) -> torch.Tensor:
    """The core of ObjRecRANSAC's hypotheses: each scene pair ``(i1, i2)``
    matched to the model pair (among those starting at ``mp1``, each with its
    first partner at the pair distance) closest in PPF space, and the rigid
    transform between the two pairs' frames. ``[H, 4, 4]``."""
    i1, i2, mp1 = i1.long(), i2.long(), mp1.long()
    sf = _ppf_feat(sxyz[i1], snormals[i1], sxyz[i2], snormals[i2])        # [H, 4]
    okm = _partners(mxyz, mmask, mp1, pair_dist, dist_tol)                # [512, M]
    mp2 = torch.argmax(okm.to(torch.int8), dim=1)
    mp_ok = okm.gather(1, mp2[:, None])[:, 0] & mmask[mp1]
    mf = _ppf_feat(mxyz[mp1], mnormals[mp1], mxyz[mp2], mnormals[mp2])    # [512, 4]
    fd = torch.sum((sf[:, None, :] - mf[None]) ** 2, dim=-1)
    fd = torch.where(mp_ok[None, :], fd, math.inf)
    best = torch.argmin(fd, dim=1)
    Rs = _pair_frame(sxyz[i1], sxyz[i2], snormals[i1])
    b1, b2 = mp1[best], mp2[best]
    Rm = _pair_frame(mxyz[b1], mxyz[b2], mnormals[b1])
    R = Rs @ Rm.transpose(-1, -2)
    t = sxyz[i1] - torch.einsum("hij,hj->hi", R, mxyz[b1])
    return transforms.from_rt(R, t)


def _orr_support(T, mxyz, mmask, sxyz, smask, inlier_dist: float) -> torch.Tensor:
    """The share of the model's valid points within ``inlier_dist`` of the
    scene under each hypothesis, ``[H]``: one B1 call of ``H M`` queries."""
    H, M = T.shape[0], mxyz.shape[0]
    cur = transforms.transform_points(T, mxyz[None].expand(H, M, 3))
    _, d2 = bruteforce.nn1(sxyz, smask, cur.reshape(H * M, 3))
    r = _f32(inlier_dist)
    hit = mmask[None, :] & (d2.reshape(H, M) <= _f32(r * r))
    return torch.sum(hit.to(torch.int32), dim=1) / torch.clamp(
        torch.sum(mmask.to(torch.int32)), min=1)


def obj_rec_ransac(
    model: Cloud,
    scene: Cloud,
    pair_dist: float,
    n_hypotheses: int = 256,
    dist_tol: float = 0.05,
    inlier_dist: float = 0.05,
    refine: bool = True,
    seed: int = 0,
    draws=None,
):
    """Detect ``model`` in ``scene`` (both with normals): ``(T [4, 4]
    numpy, support in [0, 1])``. The draws come from a generator seeded
    ``seed`` on the scene's device unless ``draws = (i1, i2, mp1)`` is
    given."""
    if draws is None:
        gen = torch.Generator(device=scene.xyz.device)
        gen.manual_seed(seed)
        draws = draw_orr_samples(scene, model, pair_dist, dist_tol, n_hypotheses, gen)
    T = _orr_hypotheses(*draws, scene.xyz, scene.mask, scene.attrs[ATTR_NORMAL], model.xyz,
                        model.mask, model.attrs[ATTR_NORMAL], pair_dist, dist_tol)
    support = _orr_support(T, model.xyz, model.mask, scene.xyz, scene.mask, inlier_dist)
    best = torch.argmax(support)
    T_best, s_best = T[best], float(support[best])
    if refine:
        T_best = trimmed_icp(model, scene, trim_fraction=0.7, init=T_best).transform
        s_best = float(_orr_support(T_best[None], model.xyz, model.mask, scene.xyz, scene.mask,
                                    inlier_dist)[0])
    return T_best.cpu().numpy(), s_best


def distance_map(mask_img: torch.Tensor, rows: int = 64) -> torch.Tensor:
    """Euclidean distance of every pixel of a ``[H, W]`` bool mask to the
    nearest True pixel (1e10 where there is none)."""
    H, W = mask_img.shape
    dev = mask_img.device
    r = torch.arange(H, device=dev)[:, None].expand(H, W)
    above = torch.cummax(torch.where(mask_img, r, -1), dim=0).values
    below = torch.flip(torch.cummax(torch.flip(torch.where(mask_img, H - 1 - r, -1), (0,)),
                                    dim=0).values, (0,))
    big = 1e10
    down = torch.where(above >= 0, (r - above).to(torch.float32), big)
    up = torch.where(below >= 0, ((H - 1 - r) - below).to(torch.float32), big)
    dy2 = torch.minimum(down, up) ** 2
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    off2 = (xs[:, None] - xs[None, :]) ** 2
    d2 = torch.cat([torch.amin(dy2[s:s + rows, None, :] + off2[None], dim=-1)
                    for s in range(0, H, rows)])
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)


def draw_oriented_point_pairs(cloud: Cloud, pair_dist: float, n_pairs: int = 256,
                              dist_tol: float = 0.05,
                              gen: Optional[torch.Generator] = None):
    """The sampler of :func:`sample_oriented_point_pairs`: ``(i1, i2)``."""
    gen = generator(cloud.xyz.device, gen)
    return _draw_pairs(gen, cloud.xyz, cloud.mask, n_pairs, pair_dist, dist_tol)


def oriented_point_pairs_core(cloud: Cloud, pair_dist: float, i1: torch.Tensor,
                              i2: torch.Tensor, dist_tol: float = 0.05):
    """``(i1, i2, valid)`` of the drawn pairs, int32, int32, bool: ``valid``
    where the partner lies at the pair distance and the first point is
    valid."""
    i1, i2 = i1.long(), i2.long()
    d = norm3(cloud.xyz[i2] - cloud.xyz[i1])
    valid = cloud.mask[i2] & (torch.abs(d - _f32(pair_dist)) < _f32(dist_tol)) & cloud.mask[i1]
    return i1.to(torch.int32), i2.to(torch.int32), valid


def sample_oriented_point_pairs(cloud: Cloud, pair_dist: float, n_pairs: int = 256,
                                dist_tol: float = 0.05, seed: int = 0, draws=None):
    """Oriented point pairs about ``pair_dist`` apart (obj_rec_ransac.h
    sampleOrientedPointPairs); requires normals. Returns ``(i1 [P] int32,
    i2 [P] int32, valid [P] bool)``."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("sample_oriented_point_pairs requires normals")
    if draws is None:
        gen = torch.Generator(device=cloud.xyz.device)
        gen.manual_seed(seed)
        draws = draw_oriented_point_pairs(cloud, pair_dist, n_pairs, dist_tol, gen)
    return oriented_point_pairs_core(cloud, pair_dist, *draws, dist_tol=dist_tol)


def pair_feature_hash_table(cloud: Cloud, pair_dist: float, n_pairs: int = 2048,
                            dist_tol: float = 0.05, n_bins: int = 16, seed: int = 0,
                            draws=None) -> Tuple[np.ndarray, int]:
    """Histogram of the three PPF angles over sampled model pairs (the
    occupancy of ObjRecRANSAC's model hash table, model_library.h
    addToHashTable): ``(hist [n_bins, n_bins, n_bins] int, valid pairs)``."""
    i1, i2, valid = sample_oriented_point_pairs(cloud, pair_dist, n_pairs, dist_tol, seed, draws)
    i1, i2 = i1.long(), i2.long()
    xyz, nrm = cloud.xyz, cloud.attrs[ATTR_NORMAL]
    u = _unit(xyz[i2] - xyz[i1])
    ang = torch.stack([_acos(_dot(nrm[i1], u)), _acos(_dot(nrm[i2], u)),
                       _acos(_dot(nrm[i1], nrm[i2]))], dim=-1)
    bins = torch.clamp(xla_int32(ang / math.pi * n_bins), 0, n_bins - 1).long()
    lin = (bins[:, 0] * n_bins + bins[:, 1]) * n_bins + bins[:, 2]
    lin = torch.where(valid, lin, n_bins ** 3)
    hist = torch.bincount(lin, minlength=n_bins ** 3 + 1)[:-1].to(torch.int32)
    return (hist.cpu().numpy().reshape(n_bins, n_bins, n_bins),
            int(torch.sum(valid.to(torch.int32))))


def mask_difference(mask0: torch.Tensor, mask1: torch.Tensor) -> torch.Tensor:
    """XOR of two binary masks (mask_map.h MaskMap::getDifferenceMask)."""
    return torch.logical_xor(mask0.to(torch.bool), mask1.to(torch.bool))


def mask_erode(mask_img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Binary erosion of a mask image (mask_map.h MaskMap::erode), by the
    shared grey-scale erosion."""
    from pcl_tpu_torch.image.ops import erode
    return erode(mask_img.to(torch.float32), size=size) > 0.5
