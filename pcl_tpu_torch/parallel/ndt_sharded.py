"""Sharded NDT: the source's rows split over the ranks, the Newton system
summed by one all-reduce an iteration.

Counterpart of ``pcl_tpu/parallel/ndt_sharded.py``. Every rank builds the
voxel-Gaussian grid of the whole target itself (``ndt.build_grid``: one
launch of kernel B2 per rank), then each Newton iteration evaluates the
score, gradient and Hessian of its shard with the same ``make_score_ops``
primitives as the single-device loop and sums ``(f, g, H)`` (43 floats) by one
all-reduce. The full step's trial score is one more all-reduce of 1 float;
when it fails the Armijo test the seven halvings' scores go in one of 7
floats. The sums are equal on every rank, so every rank takes the same
branch: the Armijo test, and then the convergence test, are read back as in
the single-device loop.
"""

from __future__ import annotations

import math

import torch

from pcl_tpu_torch.core.transforms import se3_exp, transform_points
from pcl_tpu_torch.parallel.mesh import POINTS_AXIS, Axis, Mesh, _psum, _shard
from pcl_tpu_torch.registration.ndt import (
    _OFFSETS7,
    _OFFSETS27,
    _gauss_constants,
    _newton_direction,
    build_grid,
    make_score_ops,
)


def sharded_ndt(
    mesh: Mesh,
    src_xyz, src_mask, tgt_xyz, tgt_mask,
    resolution: float = 1.0,
    init_transform=None,
    *,
    max_iterations: int = 35,
    transformation_eps: float = 1e-4,
    step_size: float = 0.1,
    outlier_ratio: float = 0.55,
    neighborhood: int = 7,
    table_size: int = 1 << 18,
    min_points: int = 6,
    axis: Axis = POINTS_AXIS,
):
    """NDT's damped Newton loop over ``mesh``: returns ``(T [4,4], score,
    iterations)``, the same on every rank; ``score`` is the mean Gaussian
    score per valid source point, sign flipped (lower is better)."""
    dev = mesh.device
    T = torch.eye(4, dtype=torch.float32, device=dev) if init_transform is None \
        else torch.as_tensor(init_transform, dtype=torch.float32).to(dev)
    sx, sm = _shard(mesh, src_xyz, axis), _shard(mesh, src_mask, axis)
    grid = build_grid(tgt_xyz.to(dev), tgt_mask.to(dev), resolution,
                      table_size=table_size, min_points=min_points)
    d1, d2 = (c.to(dev) for c in _gauss_constants(resolution, outlier_ratio))
    offsets = torch.tensor({1: _OFFSETS27[:1], 7: _OFFSETS7, 27: _OFFSETS27}[neighborhood],
                           dtype=torch.int32, device=dev)
    gather_rows, score_from_rows, score_grad_hess = make_score_ops(
        grid, offsets, grid.resolution, d1, d2, sm)

    def local_score(pose):
        p = transform_points(pose, sx)
        return score_from_rows(gather_rows(p), p)

    alphas = 2.0 ** -torch.arange(1, 8, dtype=torch.float32, device=dev)
    rows = gather_rows(transform_points(T, sx))
    score = torch.full((), math.inf, dtype=torch.float32, device=dev)
    done = False
    it = 0
    while it < max_iterations and not done:
        f_l, g_l, H_l = score_grad_hess(transform_points(T, sx), rows)
        fgH = _psum(mesh, torch.cat([f_l[None], g_l, H_l.reshape(-1)]), axis)
        f0, g, H = fgH[0], fgH[1:7], fgH[7:].reshape(6, 6)
        delta = _newton_direction(g, H, step_size)
        gd = torch.dot(g, delta)
        T1 = se3_exp(delta) @ T
        p1 = transform_points(T1, sx)
        rows1 = gather_rows(p1)
        f1 = _psum(mesh, score_from_rows(rows1, p1)[None], axis)[0]
        full_ok, small = torch.stack(
            [f1 <= f0 + 1e-4 * gd, torch.linalg.norm(delta) < transformation_eps]).tolist()
        it += 1
        if full_ok:
            T, rows, score, done = T1, rows1, f1, small
            continue
        scores = _psum(mesh, torch.stack([local_score(se3_exp(a * delta) @ T)
                                          for a in alphas]), axis)
        armijo = scores <= f0 + 1e-4 * alphas * gd
        aidx = torch.argmax(armijo.to(torch.int32))
        improved = armijo[aidx] & (scores[aidx] < f0)
        step = torch.where(improved, alphas[aidx], 0.0) * delta
        T = se3_exp(step) @ T
        rows = gather_rows(transform_points(T, sx))
        score = torch.where(improved, scores[aidx], f0)
        done = bool((torch.linalg.norm(step) < transformation_eps) | ~improved)
    n_valid = _psum(mesh, torch.sum(sm.to(torch.float32))[None], axis)[0]
    return (T, -score / torch.clamp(n_valid, min=1.0),
            torch.tensor(it, dtype=torch.int32, device=dev))
