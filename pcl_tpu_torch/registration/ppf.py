"""PPF registration: Drost-style point-pair-feature voting.

Counterpart of ``pcl_tpu/registration/ppf.py`` (PCL's PPFRegistration and
PPFEstimation). The model's pair features ``(angle(n1, d), angle(n2, d),
angle(n1, n2), |d|)`` are quantized and hashed into a table of ``cap``
entries per bucket, each holding the reference point and the pair's
in-plane angle alpha; every scene pair looks up its bucket and votes for
``(scene reference, model reference, alpha bin)``; the peak vote gives the
pose (the model normal turned onto the scene normal, then alpha about it).

Like the other random aligners this is a sampler (:func:`draw_ppf_samples`)
and a deterministic core (:func:`ppf_core`) that takes the drawn indices
(ROADMAP C17). The hash keeps the JAX package's int32 arithmetic: products
wrap, ``abs(INT_MIN)`` stays negative and ``%`` is a floor modulo.
"""

from __future__ import annotations

import importlib
import math
from typing import NamedTuple, Optional

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.core.transforms import from_rt, hat
from pcl_tpu_torch.ops.segsum import add_rows

_ransac = importlib.import_module("pcl_tpu_torch.sac.ransac")

_EPS = 1e-12
_M32 = 0xFFFFFFFF
_HASH_PRIMES = (73856093, 19349669, 83492791, 67867967)


def ppf_features(p1, n1, p2, n2):
    """Batched PPF tuple ``(f1, f2, f3, f4)``."""
    d = p2 - p1
    f4 = torch.linalg.vector_norm(d, dim=-1)
    dn = d / torch.clamp(f4, min=_EPS)[..., None]
    f1 = torch.arccos(torch.clamp(torch.sum(n1 * dn, dim=-1), -1, 1))
    f2 = torch.arccos(torch.clamp(torch.sum(n2 * dn, dim=-1), -1, 1))
    f3 = torch.arccos(torch.clamp(torch.sum(n1 * n2, dim=-1), -1, 1))
    return f1, f2, f3, f4


def _abs_mod(h: torch.Tensor, table_size: int) -> torch.Tensor:
    """``abs(h) % table_size`` for int32 ``h`` (held in int64) as int32
    arithmetic gives it: ``abs(INT_MIN)`` is ``INT_MIN``, and the modulo
    floors."""
    a = torch.where(h == -2 ** 31, h, torch.abs(h))
    return torch.remainder(a, table_size).to(torch.int32)


def _quantize(f1, f2, f3, f4, angle_step, dist_step, table_size):
    """The bucket of a quantized PPF: ``|q1 p1 ^ q2 p2 ^ q3 p3 ^ q4 p4| %
    table_size`` in int32 arithmetic (the products wrap), emulated in
    int64."""
    h = torch.zeros(f1.shape, dtype=torch.int64, device=f1.device)
    for f, step, p in zip((f1, f2, f3, f4), (angle_step, angle_step, angle_step, dist_step),
                          _HASH_PRIMES):
        q = (f / step).to(torch.int32).to(torch.int64)
        h = h ^ ((q * p) & _M32)
    return _abs_mod(torch.where(h > 2 ** 31 - 1, h - 2 ** 32, h), table_size)


def _alpha(p_ref, n_ref, p_other):
    """In-plane angle of ``p_other`` about the axis ``(p_ref, n_ref)`` in the
    canonical frame with x along ``n_ref`` (Drost's alpha)."""
    x = n_ref
    ex = x.new_tensor([1.0, 0.0, 0.0]).expand(x.shape)
    ey = x.new_tensor([0.0, 1.0, 0.0]).expand(x.shape)
    a = torch.where(torch.abs(x[..., 0:1]) < 0.9, ex, ey)
    y = torch.linalg.cross(x, a)
    y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=_EPS)
    z = torch.linalg.cross(x, y)
    d = p_other - p_ref
    return torch.arctan2(torch.sum(d * z, dim=-1), torch.sum(d * y, dim=-1))


class PPFResult(NamedTuple):
    transform: torch.Tensor
    votes: torch.Tensor
    valid: torch.Tensor


def draw_ppf_samples(model_mask: torch.Tensor, scene_mask: torch.Tensor, n_model: int,
                     n_scene_ref: int, n_scene: int, gen: Optional[torch.Generator] = None):
    """:func:`ppf_register`'s sampler: model points, scene reference points
    and scene points, each drawn among the valid ones."""
    gen = _ransac.generator(model_mask.device, gen)
    m_idx = _ransac.categorical(gen, model_mask, (n_model,)).to(torch.int32)
    sr_idx = _ransac.categorical(gen, scene_mask, (n_scene_ref,)).to(torch.int32)
    s_idx = _ransac.categorical(gen, scene_mask, (n_scene,)).to(torch.int32)
    return m_idx, sr_idx, s_idx


def ppf_core(model: Cloud, scene: Cloud, m_idx: torch.Tensor, sr_idx: torch.Tensor,
             s_idx: torch.Tensor, *, angle_step: float = math.pi / 15, dist_step: float = 0.05,
             table_size: int = 1 << 16, cap: int = 8, n_alpha: int = 30) -> PPFResult:
    """The deterministic part of :func:`ppf_register` on the drawn indices."""
    dev = model.xyz.device
    mp, mn = model.xyz[m_idx.long()], model.attrs[ATTR_NORMAL][m_idx.long()]
    sp_ref, sn_ref = scene.xyz[sr_idx.long()], scene.attrs[ATTR_NORMAL][sr_idx.long()]
    sp, sn = scene.xyz[s_idx.long()], scene.attrs[ATTR_NORMAL][s_idx.long()]
    n_model, n_scene_ref, n_scene = len(m_idx), len(sr_idx), len(s_idx)

    # the model's pair table: every ordered pair (i, j), i != j
    i = torch.arange(n_model, device=dev).repeat_interleave(n_model)
    j = torch.arange(n_model, device=dev).repeat(n_model)
    hh = _quantize(*ppf_features(mp[i], mn[i], mp[j], mn[j]), angle_step, dist_step,
                   table_size)
    hh = torch.where(i != j, hh, table_size)
    alpha_m = _alpha(mp[i], mn[i], mp[j])
    order = torch.argsort(hh, stable=True)
    hs = hh[order].long()
    start = torch.searchsorted(hs, torch.arange(table_size + 2, device=dev))
    rank = torch.arange(hs.shape[0], device=dev) - start[hs]
    # a pair past its bucket's cap, and every pair of the i == j bucket,
    # lands in row table_size, which no lookup reads (a bucket is < table_size)
    flat = torch.where(rank < cap, hs * cap + rank, table_size * cap)
    tbl_ref = torch.full(((table_size + 1) * cap,), -1, dtype=torch.int32, device=dev)
    tbl_alpha = torch.zeros((table_size + 1) * cap, dtype=torch.float32, device=dev)
    tbl_ref = tbl_ref.index_put_((flat,), i[order].to(torch.int32)).reshape(table_size + 1, cap)
    tbl_alpha = tbl_alpha.index_put_((flat,), alpha_m[order]).reshape(table_size + 1, cap)

    # the scene's votes
    si = torch.arange(n_scene_ref, device=dev).repeat_interleave(n_scene)
    sj = torch.arange(n_scene, device=dev).repeat(n_scene_ref)
    sh = _quantize(*ppf_features(sp_ref[si], sn_ref[si], sp[sj], sn[sj]), angle_step,
                   dist_step, table_size).long()
    alpha_s = _alpha(sp_ref[si], sn_ref[si], sp[sj])
    cand_ref = tbl_ref[sh]                                 # [P, cap]
    ok = cand_ref >= 0
    d_alpha = alpha_s[:, None] - tbl_alpha[sh]
    a_bin = torch.remainder(
        xla_int32(torch.floor((d_alpha + math.pi) / (2 * math.pi) * n_alpha)), n_alpha)
    acc_idx = (si[:, None] * n_model + torch.clamp(cand_ref.long(), 0, n_model - 1)) \
        * n_alpha + a_bin
    n_acc = n_scene_ref * n_model * n_alpha
    acc_idx = torch.where(ok, acc_idx, n_acc)
    votes = add_rows(torch.zeros(n_acc + 1, dtype=torch.int32, device=dev),
                     acc_idx.reshape(-1), ok.to(torch.int32).reshape(-1))[:-1]
    best = torch.argmax(votes)
    n_votes = votes[best]
    b_sref = best // (n_model * n_alpha)
    b_mref = (best // n_alpha) % n_model
    b_alpha = (best % n_alpha + 0.5) / n_alpha * 2 * math.pi - math.pi

    # the pose: the model normal turned onto the scene normal, alpha about
    # it, and the reference points brought together
    nm, ns = mn[b_mref], sn_ref[b_sref]
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    v = torch.linalg.cross(nm, ns)
    s = torch.linalg.vector_norm(v)
    c = torch.dot(nm, ns)
    vx = hat(v)
    R_align = eye + vx + vx @ vx * ((1 - c) / torch.clamp(s * s, min=_EPS))
    R_align = torch.where(s < 1e-6, torch.where(c > 0, eye, -eye), R_align)
    K = hat(ns)
    R_alpha = eye + torch.sin(b_alpha) * K + (1 - torch.cos(b_alpha)) * (K @ K)
    R = R_alpha @ R_align
    t = sp_ref[b_sref] - R @ mp[b_mref]
    return PPFResult(transform=from_rt(R, t), votes=n_votes, valid=n_votes > 0)


def ppf_register(model: Cloud, scene: Cloud, *, gen: Optional[torch.Generator] = None,
                 n_model: int = 192, n_scene_ref: int = 32, n_scene: int = 192,
                 angle_step: float = math.pi / 15, dist_step: float = 0.05,
                 table_size: int = 1 << 16, cap: int = 8, n_alpha: int = 30) -> PPFResult:
    """Find the model's pose in the scene by PPF voting; both clouds need
    normals."""
    if ATTR_NORMAL not in model.attrs or ATTR_NORMAL not in scene.attrs:
        raise ValueError("ppf_register requires normals on both clouds")
    draws = draw_ppf_samples(model.mask, scene.mask, n_model, n_scene_ref, n_scene, gen)
    return ppf_core(model, scene, *draws, angle_step=angle_step, dist_step=dist_step,
                    table_size=table_size, cap=cap, n_alpha=n_alpha)
