"""ICP variants beyond the core loop: nonlinear (LM) and joint multi-pair.

Counterpart of ``pcl_tpu/registration/variants.py``: ``icp_nl`` estimates
each increment by Levenberg-Marquardt over a warp parameterization
(PCL's IterativeClosestPointNonLinear), and ``joint_icp`` constrains several
source/target pairs to one rigid transform (PCL's
JointIterativeClosestPoint: correspondences per pair, one Umeyama estimate
over their union). Both keep ``registration/icp.py``'s structure and
convergence codes: brute-force 1-NN correspondences (kernel B1 on CUDA
tensors), a Python loop whose state stays on the device, and the code read
back once an iteration.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.core.transforms import transform_points
from pcl_tpu_torch.registration import correspondence as corr_mod
from pcl_tpu_torch.registration import estimation
from pcl_tpu_torch.registration.icp import (
    CONV_ABS_MSE,
    CONV_FAILED_CORRESPONDENCES,
    CONV_ITERATIONS,
    CONV_REL_MSE,
    CONV_RUNNING,
    CONV_TRANSFORM,
    ICPResult,
    _gather,
    _masked_mse,
)

_WARPS = {
    "rigid_6d": (estimation.warp_rigid_6d, 6),
    "rigid_3d": (estimation.warp_rigid_3d, 3),
    "translation": (estimation.warp_translation, 3),
}


def _code(ok, small, diff, mse, it: int, max_iterations: int, abs_mse_eps: float,
          rel_mse_eps: float) -> torch.Tensor:
    """The ``CONV_*`` code of an iteration, in ``icp``'s order of tests."""
    abs_ok = (diff < abs_mse_eps) & (it > 1)
    rel_ok = (diff < rel_mse_eps * torch.abs(mse)) & (it > 1)
    tail = CONV_ITERATIONS if it >= max_iterations else CONV_RUNNING
    return torch.where(~ok, CONV_FAILED_CORRESPONDENCES,
           torch.where(small, CONV_TRANSFORM,
           torch.where(abs_ok, CONV_ABS_MSE,
           torch.where(rel_ok, CONV_REL_MSE, tail)))).to(torch.int32)


def _result(T, it: int, mse, n_corr, code) -> ICPResult:
    dev = T.device
    return ICPResult(transform=T, converged=code > 0,
                     iterations=torch.tensor(it, dtype=torch.int32, device=dev),
                     fitness=mse, num_correspondences=n_corr, convergence_state=code,
                     truncated=torch.zeros((), dtype=torch.bool, device=dev))


def _state0(init_transform, dev):
    T = (torch.eye(4, dtype=torch.float32, device=dev) if init_transform is None
         else init_transform.to(device=dev, dtype=torch.float32))
    return (T, torch.full((), math.inf, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.full((), CONV_RUNNING, dtype=torch.int32, device=dev))


def icp_nl(
    source: Cloud,
    target: Cloud,
    init_transform: Optional[torch.Tensor] = None,
    *,
    max_corr_dist: float = math.inf,
    max_iterations: int = 50,
    transformation_eps: float = 0.0,
    abs_mse_eps: float = 1e-12,
    rel_mse_eps: float = 1e-8,
    warp: str = "rigid_6d",
    lm_iterations: int = 5,
    min_correspondences: int = 3,
) -> ICPResult:
    """Nonlinear ICP: each increment is ``lm_iterations`` Levenberg-Marquardt
    steps over the warp ``"rigid_6d"``, ``"rigid_3d"`` or ``"translation"``."""
    warp_fn, n_params = _WARPS[warp]
    dev = source.xyz.device
    sx, sm = source.xyz, source.mask
    tx, tm = target.xyz, target.mask
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    T, mse, n_corr, code = _state0(init_transform, dev)
    it = 0
    while it < max_iterations:
        src_t = transform_points(T, sx)
        c = corr_mod.determine_correspondences(src_t, sm, tx, tm, max_corr_dist)
        w = c.valid.to(torch.float32)
        n_corr = torch.sum(c.valid.to(torch.int32))
        T_delta = estimation.estimate_lm(src_t, _gather(tx, c.index), w, warp=warp_fn,
                                         n_params=n_params, iterations=lm_iterations)
        mse_new = _masked_mse(c)
        ok = n_corr >= min_correspondences
        T_delta = torch.where(ok, T_delta, eye4)
        it += 1
        t2 = torch.sum(T_delta[:3, 3] ** 2)
        cos_r = torch.clamp((torch.trace(T_delta[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        small = (t2 <= transformation_eps) & ((1.0 - cos_r) <= transformation_eps) \
            & (transformation_eps > 0.0)
        code = _code(ok, small, torch.abs(mse_new - mse), mse, it, max_iterations,
                     abs_mse_eps, rel_mse_eps)
        T = T_delta @ T
        mse = mse_new
        if int(code) != CONV_RUNNING:                 # the one read-back
            break
    return _result(T, it, mse, n_corr, code)


def joint_icp(
    sources: Sequence[Cloud],
    targets: Sequence[Cloud],
    init_transform: Optional[torch.Tensor] = None,
    *,
    max_corr_dist: float = math.inf,
    max_iterations: int = 50,
    abs_mse_eps: float = 1e-12,
    rel_mse_eps: float = 1e-8,
    min_correspondences: int = 3,
) -> ICPResult:
    """Joint ICP: one rigid transform explaining every source/target pair.
    Each iteration runs one correspondence search per pair and one Umeyama
    estimate over their union."""
    if len(sources) != len(targets) or not sources:
        raise ValueError("joint_icp needs equal-length non-empty cloud lists")
    dev = sources[0].xyz.device
    no_small = torch.zeros((), dtype=torch.bool, device=dev)
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    T, mse, n_corr, code = _state0(init_transform, dev)
    it = 0
    while it < max_iterations:
        srcs, dsts, cs = [], [], []
        for s, t in zip(sources, targets):
            src_t = transform_points(T, s.xyz)
            c = corr_mod.determine_correspondences(src_t, s.mask, t.xyz, t.mask,
                                                   max_corr_dist)
            srcs.append(src_t)
            dsts.append(_gather(t.xyz, c.index))
            cs.append(c)
        c_all = corr_mod.Correspondences(torch.cat([c.index for c in cs]),
                                         torch.cat([c.sqdist for c in cs]),
                                         torch.cat([c.valid for c in cs]))
        w_all = c_all.valid.to(torch.float32)
        n_corr = torch.sum(w_all).to(torch.int32)
        T_delta = estimation.estimate_svd(torch.cat(srcs), torch.cat(dsts), w_all)
        mse_new = _masked_mse(c_all)
        ok = n_corr >= min_correspondences
        T_delta = torch.where(ok, T_delta, eye4)
        it += 1
        code = _code(ok, no_small, torch.abs(mse_new - mse), mse, it, max_iterations,
                     abs_mse_eps, rel_mse_eps)
        T = T_delta @ T
        mse = mse_new
        if int(code) != CONV_RUNNING:                 # the one read-back
            break
    return _result(T, it, mse, n_corr, code)
