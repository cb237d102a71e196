"""2-D Normal Distributions Transform: planar scan matching (tx, ty, theta).

Counterpart of ``pcl_tpu/registration/ndt2d.py`` (PCL's
NormalDistributionsTransform2D). The target is modelled by four overlapping
grids of 2-D Gaussians, each shifted by half a cell in x and/or y; each grid
is a hashed table built by one pass of segment reductions, and a bucket
shared by two occupied cells is invalidated (its owner key is kept and
checked on lookup). Newton steps with Armijo backtracking run coarse to fine
over ``levels`` cell sizes.

The JAX package differentiates the score with ``jax.grad`` and
``jax.hessian``; here the gradient and Hessian are the closed form of the
same score (a sum of ``exp(-md / 2)`` terms, ``md`` the Mahalanobis distance
clamped at 50), formed in one pass. The Newton loop and its line search are
Python loops over device state: one read-back per line-search try and one
per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.ops.nn1 import _fma32
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.search.cell_list import _M32, _mix32

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1
_SHIFTS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5))


def _hash2(cc: torch.Tensor, table_size: int) -> torch.Tensor:
    """``[..., 2]`` int32 cell coords -> int32 bucket: each coordinate
    wrapped to uint32 (the second salted), avalanched, xor-ed; uint32
    arithmetic emulated in int64, bit for bit the JAX package's."""
    c = cc.to(torch.int64) & _M32
    h = _mix32(c[..., 0]) ^ _mix32((c[..., 1] + 0x9E3779B9) & _M32)
    return (h % table_size).to(torch.int32)


def _pack2(cc: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` int32 cell coords -> one int32 identity key, 16 bits per
    axis, wrapped into int32 as the JAX package's shift does."""
    c = cc.to(torch.int64)
    v = ((c[..., 0] & 0xFFFF) << 16) | (c[..., 1] & 0xFFFF)
    return torch.where(v > _I32_MAX, v - 2 ** 32, v).to(torch.int32)


def _eigh22(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a batch of symmetric 2x2: ``(lam [..., 2]
    ascending, V [..., 2, 2] with the eigenvectors as columns)``."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
    tr = a + c
    det = a * c - b * b
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    l1 = tr / 2.0 - disc
    l2 = tr / 2.0 + disc
    v2 = torch.stack([b, l2 - a], -1)
    deg = torch.linalg.vector_norm(v2, dim=-1) < 1e-12
    v2 = torch.where(deg[..., None], torch.stack([torch.ones_like(b), torch.zeros_like(b)], -1),
                     v2)
    v2 = v2 / torch.clamp(torch.linalg.vector_norm(v2, dim=-1, keepdim=True), min=1e-20)
    v1 = torch.stack([-v2[..., 1], v2[..., 0]], -1)
    return torch.stack([l1, l2], -1), torch.stack([v1, v2], -1)


class NDT2DGrid(NamedTuple):
    mean: torch.Tensor    # [4, T+1, 2]
    icov: torch.Tensor    # [4, T+1, 2, 2]
    valid: torch.Tensor   # [4, T+1] bool
    shifts: torch.Tensor  # [4, 2] grid offsets in cells
    ckey: torch.Tensor    # [4, T+1] int32 packed cell of the bucket's owner


def _scatter_sum(n: int, index: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Segment sums in index order on both devices (``index_put_`` with
    ``accumulate``: duplicates are added in order on the CPU and, through a
    stable sort, on the card)."""
    out = v.new_zeros((n,) + tuple(v.shape[1:]))
    return add_rows(out, index, v)


def _one_grid(xy: torch.Tensor, mask: torch.Tensor, res: torch.Tensor, shift, table_size: int,
              min_points: int):
    nseg = table_size + 1
    w = mask.to(torch.float32)
    cc = xla_int32(torch.floor(xy / res + xy.new_tensor(shift)))
    h = torch.where(mask, _hash2(cc, table_size), table_size).long()
    pk = _pack2(cc)
    # two distinct occupied cells in one bucket merge into a bogus Gaussian:
    # such a bucket is invalidated
    pk_min = torch.full((nseg,), _I32_MAX, dtype=torch.int32, device=xy.device).scatter_reduce_(
        0, h, torch.where(mask, pk, _I32_MAX), "amin")
    pk_max = torch.full((nseg,), _I32_MIN, dtype=torch.int32, device=xy.device).scatter_reduce_(
        0, h, torch.where(mask, pk, _I32_MIN), "amax")
    cnt = _scatter_sum(nseg, h, w)
    s = _scatter_sum(nseg, h, xy * w[:, None])
    ss = _scatter_sum(nseg, h, torch.einsum("ni,nj->nij", xy, xy) * w[:, None, None])
    mean = s / torch.clamp(cnt, min=1.0)[:, None]
    # ss - mean s^T cancels in float32: the subtraction takes the product
    # fused, as the JAX package's compiled CPU code does (C13)
    cov = _fma32(-mean[:, :, None], s[:, None, :], ss) / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
    lam, V = _eigh22(cov)
    lam_max = lam[..., 1]
    # the condition number is capped at 1e3
    lam_inf = torch.maximum(lam, 0.001 * lam_max[..., None])
    inv_lam = 1.0 / torch.clamp(lam_inf, min=1e-12)
    icov = torch.einsum("vik,vk,vjk->vij", V, inv_lam, V)
    valid = (cnt >= float(min_points)) & (lam_max > 0) & (pk_min == pk_max)
    return (torch.where(valid[:, None], mean, 0.0), torch.where(valid[:, None, None], icov, 0.0),
            valid, pk_min)


def build_grid_2d(
    xy: torch.Tensor,
    mask: torch.Tensor,
    grid_extent: float,
    table_size: int = 1 << 16,
    min_points: int = 3,
) -> NDT2DGrid:
    """Four half-cell-shifted grids of 2-D Gaussians over ``xy [N, 2]``: per
    bucket mean and covariance, eigenvalues raised to 1e-3 of the largest,
    valid with ``min_points`` points, a positive spread and one owner cell.
    The four grids are built one after another."""
    res = torch.tensor(float(grid_extent), dtype=torch.float32, device=xy.device)
    parts = [_one_grid(xy, mask, res, sh, table_size, min_points) for sh in _SHIFTS]
    mean, icov, valid, ckey = (torch.stack(p) for p in zip(*parts))
    shifts = torch.tensor(_SHIFTS, dtype=torch.float32, device=xy.device)
    return NDT2DGrid(mean=mean, icov=icov, valid=valid, shifts=shifts, ckey=ckey)


class NDT2DResult(NamedTuple):
    transform: torch.Tensor   # [4, 4] planar rigid transform (z identity)
    params: torch.Tensor      # [3] (tx, ty, theta)
    converged: torch.Tensor
    iterations: torch.Tensor
    score: torch.Tensor


def _score(grid: NDT2DGrid, res, xy_s, sm, p, table_size: int, derivs: bool):
    """Negative summed Gaussian score of ``xy_s`` moved by ``p`` over the four
    grids, and with ``derivs`` its gradient [3] and Hessian [3, 3] in closed
    form. A point's term is ``exp(-min(md, 50) / 2)`` where its bucket holds
    its own cell, ``md = x^T S x``, ``x = R(theta) s + t - mu``."""
    c, s = torch.cos(p[2]), torch.sin(p[2])
    R = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    q = xy_s @ R.T + p[:2][None, :]                   # [N, 2]
    f = torch.zeros((), dtype=torch.float32, device=xy_s.device)
    g = torch.zeros(3, dtype=torch.float32, device=xy_s.device)
    H = torch.zeros(3, 3, dtype=torch.float32, device=xy_s.device)
    if derivs:
        # dq/dtheta = R' s, d2q/dtheta2 = -R s
        dq = torch.stack([-(xy_s[:, 0] * s) - xy_s[:, 1] * c,
                          xy_s[:, 0] * c - xy_s[:, 1] * s], -1)
        ddq = -(q - p[:2][None, :])
    for k in range(4):
        cc = xla_int32(torch.floor(q / res + grid.shifts[k][None, :]))
        h = _hash2(cc, table_size).long()
        mu = grid.mean[k][h]
        ic = grid.icov[k][h]
        ok = grid.valid[k][h] & sm & (grid.ckey[k][h] == _pack2(cc))
        x = q - mu
        Sx = torch.einsum("nij,nj->ni", ic, x)
        md = torch.sum(x * Sx, -1)
        inside = md < 50.0
        val = torch.exp(-0.5 * torch.clamp(md, max=50.0))
        term = torch.where(ok, val, 0.0)
        f = f - torch.sum(term)
        if derivs:
            # the clamp is flat past 50: no derivative there
            wv = torch.where(ok & inside, val, 0.0)
            a = torch.stack([Sx[:, 0], Sx[:, 1], torch.sum(Sx * dq, -1)], -1)   # x^T S J
            SJt = torch.einsum("nij,nj->ni", ic, dq)
            JSJ = torch.stack([
                torch.stack([ic[:, 0, 0], ic[:, 0, 1], SJt[:, 0]], -1),
                torch.stack([ic[:, 1, 0], ic[:, 1, 1], SJt[:, 1]], -1),
                torch.stack([SJt[:, 0], SJt[:, 1], torch.sum(dq * SJt, -1)], -1)], -2)
            JSJ = JSJ.clone()
            JSJ[:, 2, 2] = JSJ[:, 2, 2] + torch.sum(Sx * ddq, -1)
            # val = exp(-md/2): d val = -val a, d2 val = val (a a^T - JSJ)
            g = g + torch.sum(wv[:, None] * a, 0)
            H = H - torch.einsum("n,nij->ij", wv, a[:, :, None] * a[:, None, :] - JSJ)
    return f, g, H


def _ndt2d_solve(grid, res, xy_s, sm, p0, max_iterations, transformation_eps, step_max,
                 table_size):
    """Newton with Armijo backtracking at one grid resolution: ``(p,
    iterations, f, converged)``."""
    dev = xy_s.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    p = p0
    f = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iterations:
        f0, g, H = _score(grid, res, xy_s, sm, p, table_size, True)
        lam = 1e-3 * torch.clamp(torch.abs(torch.trace(H)) / 3.0, min=1e-6)
        delta = -torch.linalg.solve_ex(H + lam * eye3, g[:, None])[0][:, 0]
        descent = torch.dot(delta, g) < 0.0
        delta = torch.where(descent, delta, -g)
        dn = torch.linalg.vector_norm(delta)
        delta = delta * torch.clamp(step_max / torch.clamp(dn, min=1e-12), max=1.0)
        slope = 1e-4 * torch.dot(g, delta)
        alpha = torch.ones((), dtype=torch.float32, device=dev)
        f_new = _score(grid, res, xy_s, sm, p + delta, table_size, False)[0]
        for _ in range(10):                           # one read-back a try
            if bool(f_new <= f0 + alpha * slope):
                break
            alpha = alpha * 0.5
            f_new = _score(grid, res, xy_s, sm, p + alpha * delta, table_size, False)[0]
        improved = f_new < f0
        step = torch.where(improved, alpha, 0.0) * delta
        p = p + step
        # converged: an accepted step below the epsilon, or a stalled line
        # search at a real optimum (f0 < 0: the score sees overlap)
        conv = (improved & (torch.linalg.vector_norm(step) < transformation_eps)) | (
            (~improved) & (f0 < -1e-6))
        f = torch.where(improved, f_new, f0)
        it += 1
        if bool(conv | ~improved):                    # the iteration's read-back
            break
    return p, it, f, conv


def ndt_2d(
    source: Cloud,
    target: Cloud,
    grid_extent: float = 1.0,
    init_params: Optional[torch.Tensor] = None,
    *,
    max_iterations: int = 50,
    transformation_eps: float = 1e-5,
    step_max: float = 0.5,
    table_size: int = 1 << 16,
    levels: int = 3,
) -> NDT2DResult:
    """Estimate ``(tx, ty, theta)`` aligning ``source`` onto ``target`` in the
    xy plane. ``grid_extent`` is the finest cell; ``levels`` runs coarse to
    fine over cells ``grid_extent * 2^(levels-1) .. grid_extent``, each
    coarser level with ``max(max_iterations // 2, 8)`` iterations."""
    dev = source.xyz.device
    xy_t = target.xyz[:, :2]
    xy_s = source.xyz[:, :2]
    sm = source.mask
    p = (torch.zeros(3, dtype=torch.float32, device=dev) if init_params is None
         else torch.as_tensor(init_params, dtype=torch.float32, device=dev))

    def solve_at(cell: float, p0, iters: int):
        grid = build_grid_2d(xy_t, target.mask, cell, table_size=table_size)
        res = torch.tensor(float(cell), dtype=torch.float32, device=dev)
        return _ndt2d_solve(grid, res, xy_s, sm, p0, iters, transformation_eps, step_max,
                            table_size)

    for lvl in range(levels - 1, 0, -1):
        p = solve_at(grid_extent * (2.0 ** lvl), p, max(max_iterations // 2, 8))[0]
    p, it, f, conv = solve_at(grid_extent, p, max_iterations)
    c, s = torch.cos(p[2]), torch.sin(p[2])
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    T = torch.stack([torch.stack([c, -s, zero, p[0]]), torch.stack([s, c, zero, p[1]]),
                     torch.stack([zero, zero, one, zero]), torch.stack([zero, zero, zero, one])])
    n_valid = torch.clamp(torch.sum(sm.to(torch.float32)), min=1.0)
    return NDT2DResult(transform=T, params=p, converged=conv & torch.isfinite(f),
                       iterations=torch.tensor(it, dtype=torch.int32, device=dev),
                       score=-f / n_valid)
