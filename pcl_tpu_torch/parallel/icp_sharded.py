"""Sharded ICP: the source's rows split over the ranks, the target
replicated, the statistics summed by one all-reduce an iteration.

Counterpart of ``pcl_tpu/parallel/icp_sharded.py``. Each rank matches its
block of the source against the whole target (kernel B1 through
``bruteforce.nn1``, or the cell list ``cell_list.nn1_radius``), accumulates
Umeyama moments (point-to-point) or the 6x6 point-to-plane system, and one
``all_reduce`` of the flattened statistics (18 or 44 floats) gives every rank
the same global sums; the update is computed on every rank alike. The JAX
package's ``lax.while_loop`` is a Python loop of ``max_iterations`` steps with
no read-back, as there (no convergence test).

``corr_backend="cell_blocked"``: the JAX package serves it with the windowed
span sweep ``cell_list.nn1_radius_blocked`` (a TPU gather layout the port
drops, ROADMAP C6). The port keeps its per-shard sort by dense cell id and
serves every step with ``nn1_radius`` on the same dense table: the same
nearest neighbours, through the same loop as 'cell'.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pcl_tpu_torch.core.geometry import rotation_from_cross_covariance
from pcl_tpu_torch.core.transforms import se3_exp, transform_points
from pcl_tpu_torch.parallel.mesh import POINTS_AXIS, Axis, Mesh, _psum, _shard
from pcl_tpu_torch.search import bruteforce, cell_list

_EPS = 1e-12


def _umeyama_from_moments(S0, Ss, Sd, M):
    """Rigid transform from summable moments: ``S0 = sum w``, ``Ss = sum w
    src``, ``Sd = sum w dst``, ``M = sum w dst src^T``; ``H = M - mu_d
    Ss^T`` is ``geometry.umeyama``'s cross-covariance."""
    S0 = torch.clamp(S0, min=_EPS)
    mu_s = Ss / S0
    mu_d = Sd / S0
    H = M - torch.outer(mu_d, Ss)
    R = rotation_from_cross_covariance(H)
    t = mu_d - R @ mu_s
    T = torch.eye(4, dtype=H.dtype, device=H.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _local_moments(src_t, src_mask, tgt_xyz, tgt_mask, tgt_normals, max_corr_dist,
                   variant: str, table=None) -> torch.Tensor:
    """Correspondences and statistics of one shard, flattened into one
    buffer for one all-reduce: ``[n, sse, S0, Ss, Sd, M]`` (18 floats) or
    ``[n, sse, JtJ, Jtr]`` (44)."""
    if table is not None:
        idx, d2, _trunc = cell_list.nn1_radius(table, src_t, max_corr_dist, compact=True)
        valid = src_mask & torch.isfinite(d2)
    else:
        idx, d2 = bruteforce.nn1(tgt_xyz, tgt_mask, src_t)
        valid = src_mask & torch.isfinite(d2) & (d2 <= float(np.float32(max_corr_dist) ** 2))
    w = valid.to(torch.float32)
    idxc = torch.clamp(idx.long(), 0, tgt_xyz.shape[0] - 1)
    dst = tgt_xyz[idxc]
    # d2 is +inf for an unmatched point on the cell backend: select (ROADMAP C7)
    head = torch.stack([torch.sum(w), torch.sum(torch.where(valid, d2, 0.0))])
    if variant == "point_to_point":
        return torch.cat([head, torch.sum(w)[None], torch.sum(src_t * w[:, None], dim=0),
                          torch.sum(dst * w[:, None], dim=0),
                          torch.einsum("ni,nj->ij", dst * w[:, None], src_t).reshape(-1)])
    nrm = tgt_normals[idxc]
    r = torch.sum(nrm * (src_t - dst), dim=-1)
    J = torch.cat([nrm, torch.linalg.cross(src_t, nrm)], dim=-1)
    Jw = J * w[:, None]
    return torch.cat([head, (J.T @ Jw).reshape(-1), Jw.T @ r])


def _update_from_stats(stats: torch.Tensor, T: torch.Tensor, variant: str):
    n, sse = stats[0], stats[1]
    if variant == "point_to_point":
        T_delta = _umeyama_from_moments(stats[2], stats[3:6], stats[6:9],
                                        stats[9:18].reshape(3, 3))
    else:
        JtJ, Jtr = stats[2:38].reshape(6, 6), stats[38:44]
        eye6 = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
        H = JtJ + 1e-9 * torch.trace(JtJ) * eye6
        T_delta = se3_exp(torch.linalg.solve_ex(H, -Jtr)[0])
    T_delta = torch.where(n >= 3, T_delta, torch.eye(4, dtype=T.dtype, device=T.device))
    return T_delta @ T, sse / torch.clamp(n, min=1.0)


def _step(mesh, variant, axis, sx, sm, tx, tm, tn, T, max_corr_dist, table):
    stats = _local_moments(transform_points(T, sx), sm, tx, tm, tn, max_corr_dist,
                           variant, table=table)
    return _update_from_stats(_psum(mesh, stats, axis), T, variant)


def sharded_icp_step(mesh: Mesh, variant: str = "point_to_point", axis: Axis = POINTS_AXIS,
                     with_table=None):
    """One ICP iteration over ``mesh``: returns ``step(src_xyz, src_mask,
    tgt_xyz, tgt_mask, tgt_normals, T, max_corr_dist[, table]) -> (T_new,
    mse)``, every argument global (the rank takes its block of the source);
    ``table`` is a cell list over the target serving the correspondences.
    ``with_table`` is accepted for the JAX package's signature (there it
    gives the table's structure) and not needed here."""
    def step(src_xyz, src_mask, tgt_xyz, tgt_mask, tgt_normals, T, max_corr_dist, *rest):
        return _step(mesh, variant, axis, _shard(mesh, src_xyz, axis),
                     _shard(mesh, src_mask, axis), tgt_xyz, tgt_mask, tgt_normals, T,
                     max_corr_dist, rest[0] if rest else None)
    return step


def sharded_icp(
    mesh: Mesh,
    src_xyz, src_mask, tgt_xyz, tgt_mask,
    tgt_normals=None,
    init_transform=None,
    max_corr_dist=math.inf,
    max_iterations: int = 30,
    variant: str = "point_to_point",
    axis: Axis = POINTS_AXIS,
    corr_backend: str = "auto",
    cell_cap: int = 16,
    table_size: int = 1 << 17,
    grid_dims=None,
):
    """ICP over ``mesh`` for ``max_iterations`` iterations: returns ``(T,
    mse, iterations)``, the same on every rank.

    With a finite gate and ``corr_backend`` 'auto' (above 1e8 candidate
    pairs, or with ``grid_dims``) or 'cell', the target's cell list is built
    once on every rank and serves each shard's correspondences;
    'cell_blocked' (point-to-point, dense ``grid_dims``) sorts each shard by
    cell first."""
    dev = mesh.device
    T = torch.eye(4, dtype=torch.float32, device=dev) if init_transform is None \
        else torch.as_tensor(init_transform, dtype=torch.float32).to(dev)
    sx, sm = _shard(mesh, src_xyz, axis), _shard(mesh, src_mask, axis)
    tx, tm = tgt_xyz.to(dev), tgt_mask.to(dev)
    tn = torch.zeros_like(tx) if tgt_normals is None else tgt_normals.to(dev)
    iters = torch.tensor(max_iterations, dtype=torch.int32, device=dev)

    blocked = corr_backend == "cell_blocked"
    if blocked and variant != "point_to_point":
        raise ValueError("cell_blocked supports point_to_point only")
    if blocked and grid_dims is None:
        raise ValueError("cell_blocked requires dense grid_dims")
    finite_gate = bool(np.isfinite(float(max_corr_dist)))
    big = src_xyz.shape[0] * tgt_xyz.shape[0] > 1e8 or grid_dims is not None
    table = None
    if blocked or corr_backend == "cell" or (corr_backend == "auto" and finite_gate and big):
        table = cell_list.build(tx, tm, np.float32(2.0 * float(max_corr_dist)),
                                table_size=table_size, cap=cell_cap, dims=grid_dims)
    if blocked:
        # each shard sorted once by the table's row-major cell id, as in the
        # JAX package (whose windowed sweep streams in that order); here the
        # order changes only the order of the sums
        skey = cell_list._dense_id(cell_list._query_coords(table, sx), table.dims)
        order = torch.argsort(torch.where(sm, skey, 2 ** 31 - 1), stable=True)
        sx, sm = sx[order], sm[order]
    mse = torch.full((), math.inf, dtype=torch.float32, device=dev)
    for _ in range(max_iterations):
        T, mse = _step(mesh, variant, axis, sx, sm, tx, tm, tn, T, max_corr_dist, table)
    return T, mse, iters
