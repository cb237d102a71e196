"""Generalized ICP (plane-to-plane): per-point covariances and a Gauss-Newton
inner loop on the se(3) twist.

Counterpart of ``pcl_tpu/registration/gicp.py``. Every point carries the
covariance of a flat disc, ``C = V diag(eps, 1, 1) V^T`` in the eigenbasis of
its k-NN covariance. An outer iteration matches the transformed source to the
target (brute-force 1-NN through kernel B1, or the cell list for a finite gate
on large pairs), fixes each pair's information ``M = (C_t + R C_s R^T)^-1`` and
minimises ``sum d^T M d`` by ``inner_iterations`` Gauss-Newton steps with a
closed-form linearisation. The JAX package runs the outer loop as one
``lax.while_loop`` over ``[9, N]`` lane-form matrices; here it is a Python loop
over ``[N, 3, 3]`` tensors that stay on the device, with the convergence flag
the one value read back per iteration. All arithmetic is float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcl_tpu_torch import search as search_mod
from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import ATTR_RGB, Cloud
from pcl_tpu_torch.core.transforms import hat, se3_exp, transform_points
from pcl_tpu_torch.features.shot import _rgb_to_lab
from pcl_tpu_torch.ops import batch33
from pcl_tpu_torch.search import bruteforce, cell_list
from pcl_tpu_torch.utils import trace


# the JAX package's ``gicp._skew`` (``registration/graph.py`` imports it) is the
# cross-product matrix, ``transforms.hat``
_skew = hat


def regularized_covariances(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    k: int = 20,
    epsilon: float = 1e-3,
    backend: str = "auto",
    cell_cap: int = 24,
    table_size: int = 1 << 17,
    grid_dims=None,
    cell_size=None,
    with_trunc: bool = False,
):
    """GICP surface covariances ``[N, 3, 3]``: ``C = V diag(eps, 1, 1) V^T``
    from the eigenbasis (ascending) of each point's k-NN covariance; the
    identity for masked points and neighbourhoods of fewer than 3.

    ``backend``: ``"brute"`` is the exact O(N^2) kNN; ``"cell"`` the cell-list
    kNN within ``cell_size``, by default the radius expected to hold ~2k
    neighbours at the bounding box's density; ``"auto"`` takes cells above
    32,768 points. ``grid_dims`` switches the cell list to the dense
    collision-free grid and needs an explicit ``cell_size``. ``with_trunc``
    returns ``(C, any_truncated)``: True means a neighbourhood lost points to
    a full bucket (raise ``cell_cap``)."""
    use_cells = backend == "cell" or (backend == "auto" and xyz.shape[0] > 32768)
    trunc_any = torch.zeros((), dtype=torch.bool, device=xyz.device)
    if use_cells:
        if grid_dims is not None and cell_size is None:
            raise ValueError("grid_dims requires an explicit cell_size")
        r = np.float32(cell_size) if cell_size is not None \
            else search_mod.knn_density_radius(xyz, mask, k)
        table = cell_list.build(xyz, mask, r, table_size=table_size, cap=cell_cap,
                                dims=grid_dims)
        idx, _, valid, trunc = cell_list.knn_radius(table, xyz, k)
        trunc_any = torch.any(trunc & mask)
        if trace.enabled():
            trace.count("cell_list.valid_rows", torch.sum(mask))
    else:
        idx, _, valid = bruteforce.knn(xyz, mask, xyz, k)
    nbr = xyz[torch.clamp(idx.long(), 0, xyz.shape[0] - 1)]
    _, cov, cnt = geometry.mean_and_covariance(nbr, valid & mask[:, None])
    _, V = geometry.eigh33(cov)
    with trace.readback("cov_diag"):           # a copy from host memory waits for the stream
        d = torch.tensor([epsilon, 1.0, 1.0], dtype=cov.dtype, device=cov.device)
    C = torch.einsum("nik,k,njk->nij", V, d, V)
    ok = (cnt >= 3.0) & mask
    C = torch.where(ok[:, None, None], C, torch.eye(3, dtype=cov.dtype, device=cov.device))
    return (C, trunc_any) if with_trunc else C


class GICPResult(NamedTuple):
    transform: torch.Tensor   # [4, 4]
    converged: torch.Tensor   # bool: the last inner twist fell below transformation_eps
    iterations: torch.Tensor  # int32 outer iterations
    fitness: torch.Tensor     # f32 mean squared distance of the matched points
    truncated: torch.Tensor   # bool: a cell-list bucket overflowed in the
                              # covariance neighbourhoods or in a
                              # correspondence sweep (raise cell_cap or
                              # cov_cell_cap); False on the brute backends


def _pair_information(Cq: torch.Tensor, Cs: torch.Tensor, R: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Per-pair Mahalanobis information ``w (C_t + R C_s R^T + 1e-9 I)^-1``,
    ``[N, 3, 3]``."""
    A = batch33.add_scaled_identity(Cq + batch33.sandwich(R, Cs), 1e-9)
    return batch33.scale(batch33.inv(A), w)


def _mahalanobis_gn(T: torch.Tensor, sx: torch.Tensor, q: torch.Tensor,
                    M: torch.Tensor, inner_iterations: int):
    """``inner_iterations`` Gauss-Newton steps on the left twist with the
    information ``M`` fixed: minimise ``sum (T p - q)^T M (T p - q)``. Returns
    ``(T_new, xis [inner_iterations, 6])``. With ``J = [I | -[p]x]`` per point,
    ``H = sum J^T M J`` and ``g = sum J^T M r`` are one reduction each."""
    n = sx.shape[0]
    eye3 = torch.eye(3, dtype=sx.dtype, device=sx.device).expand(n, 3, 3)
    eye6 = torch.eye(6, dtype=sx.dtype, device=sx.device)
    xis = []
    for _ in range(inner_iterations):
        p = transform_points(T, sx)
        J = torch.cat([eye3, -hat(p)], dim=2)                       # [N, 3, 6]
        g = torch.einsum("nai,na->i", J, batch33.matvec(M, p - q))
        MJ = batch33.matmul(M, J)
        H = J.reshape(3 * n, 6).T @ MJ.reshape(3 * n, 6)
        H = H + 1e-6 * torch.trace(H) / 6.0 * eye6
        xi = -torch.linalg.solve_ex(H, g)[0]
        T = se3_exp(xi) @ T
        xis.append(xi)
    return T, torch.stack(xis)


def _gicp_loop(source, target, init_transform, find, Cs, Ct, trunc0,
               max_iterations, inner_iterations, transformation_eps) -> GICPResult:
    """The outer loop shared by ``gicp`` and ``gicp6d``: ``find(src_t)`` gives
    ``(idx, d2 with +inf where unmatched, truncated)``."""
    dev = source.xyz.device
    sx, sm, tx = source.xyz, source.mask, target.xyz
    T = torch.eye(4, dtype=torch.float32, device=dev) if init_transform is None \
        else init_transform.to(device=dev, dtype=torch.float32)
    mse = torch.full((), math.inf, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    trunc = trunc0
    it = 0
    while it < max_iterations:
        with trace.span("gicp.iteration"):
            with trace.span("gicp.correspond"):
                idx, d2, trunc_new = find(transform_points(T, sx))
            with trace.span("gicp.solve"):
                valid = sm & torch.isfinite(d2)
                w = valid.to(torch.float32)
                idxc = torch.clamp(idx.long(), 0, target.capacity - 1)
                M = _pair_information(Ct[idxc], Cs, T[:3, :3], w)
                T, xis = _mahalanobis_gn(T, sx, tx[idxc], M, inner_iterations)
                # d2 is +inf for an unmatched point: select, do not weigh
                mse = torch.sum(torch.where(valid, d2, 0.0)) / torch.clamp(torch.sum(w), min=1.0)
                done = torch.linalg.norm(xis[-1]) < transformation_eps
                trunc = trunc | trunc_new
            it += 1
            with trace.readback("gicp_converged"):    # the one value read back
                stop = bool(done)
        if stop:
            break
    with trace.readback("gicp_iterations"):
        its = torch.tensor(it, dtype=torch.int32, device=dev)
    return GICPResult(transform=T, converged=done, iterations=its, fitness=mse,
                      truncated=trunc)


def _use_cells(corr_backend: str, max_corr_dist: float, source: Cloud, target: Cloud) -> bool:
    big = source.capacity * target.capacity > 1e8
    return corr_backend == "cell" or (
        corr_backend == "auto" and bool(np.isfinite(max_corr_dist)) and big)


def gicp(
    source: Cloud,
    target: Cloud,
    init_transform: Optional[torch.Tensor] = None,
    *,
    max_corr_dist: float = math.inf,
    max_iterations: int = 50,
    inner_iterations: int = 2,
    transformation_eps: float = 5e-4,
    k_covariances: int = 20,
    epsilon: float = 1e-3,
    corr_backend: str = "auto",
    cell_cap: int = 32,
    table_size: int = 1 << 17,
    grid_dims=None,
    cov_cell_size=None,
    cov_grid_dims=None,
    cov_cell_cap: int = 24,
) -> GICPResult:
    """Plane-to-plane GICP alignment: the 4x4 transform and statistics.

    Correspondences come from the brute 1-NN, or from the cell list (cells of
    ``2 * max_corr_dist``) for a finite gate on more than 1e8 candidate pairs
    or with ``corr_backend="cell"``; ``grid_dims`` makes that list the dense
    collision-free grid. ``cov_cell_size``, ``cov_grid_dims`` and
    ``cov_cell_cap`` shape the cell list of the k-NN neighbourhoods behind the
    covariances. Truncation anywhere shows in ``GICPResult.truncated``."""
    sx, sm = source.xyz, source.mask
    tx, tm = target.xyz, target.mask
    cov_kw = dict(backend="cell" if corr_backend == "cell" else "auto",
                  cell_cap=cov_cell_cap, grid_dims=cov_grid_dims,
                  cell_size=cov_cell_size, with_trunc=True)
    with trace.span("gicp.covariances"):
        Cs, trunc_cs = regularized_covariances(sx, sm, k_covariances, epsilon, **cov_kw)
    with trace.span("gicp.covariances"):
        Ct, trunc_ct = regularized_covariances(tx, tm, k_covariances, epsilon, **cov_kw)

    if _use_cells(corr_backend, max_corr_dist, source, target):
        table = cell_list.build(tx, tm, np.float32(2.0 * max_corr_dist),
                                table_size=table_size, cap=cell_cap, dims=grid_dims)

        def find(src_t):
            idx, d2, trunc = cell_list.nn1_radius(table, src_t, max_corr_dist, compact=True)
            if trace.enabled():
                trace.count("cell_list.valid_rows", torch.sum(sm))
            return idx, d2, torch.any(trunc & sm)
    else:
        max_d2 = float(np.float32(max_corr_dist) ** 2)
        no_trunc = torch.zeros((), dtype=torch.bool, device=sx.device)

        def find(src_t):
            idx, d2 = bruteforce.nn1(tx, tm, src_t)
            return idx, torch.where(d2 <= max_d2, d2, math.inf), no_trunc

    return _gicp_loop(source, target, init_transform, find, Cs, Ct, trunc_cs | trunc_ct,
                      max_iterations, inner_iterations, transformation_eps)


def gicp6d(
    source: Cloud,
    target: Cloud,
    init_transform: Optional[torch.Tensor] = None,
    *,
    max_corr_dist: float = math.inf,
    max_iterations: int = 50,
    inner_iterations: int = 2,
    transformation_eps: float = 5e-4,
    k_covariances: int = 20,
    epsilon: float = 1e-3,
    lab_weight: float = 0.032,
    corr_backend: str = "auto",
    cell_cap: int = 32,
    table_size: int = 1 << 17,
    cand_k: int = 8,
) -> GICPResult:
    """Colour-assisted GICP: correspondences are nearest neighbours in the
    6-D space (x, y, z, ``lab_weight`` x CIELab), the optimisation is the
    geometric one of :func:`gicp`. Both clouds need an ``rgb`` attribute in
    [0, 1].

    The brute backend searches the 6-D space and gates on the geometric
    distance. The cell backend (a finite gate on more than 1e8 pairs, or
    ``corr_backend="cell"``) takes the ``cand_k`` geometrically nearest
    candidates within ``max_corr_dist`` from the cell list and picks among
    them by the 6-D metric, so it keeps the best candidate inside the gate."""
    if ATTR_RGB not in source.attrs or ATTR_RGB not in target.attrs:
        raise ValueError("gicp6d requires 'rgb' on both clouds")
    sx, sm = source.xyz, source.mask
    tx, tm = target.xyz, target.mask
    s_lab = _rgb_to_lab(source.attrs[ATTR_RGB]) * lab_weight
    t_lab = _rgb_to_lab(target.attrs[ATTR_RGB]) * lab_weight
    Cs, trunc_cs = regularized_covariances(sx, sm, k_covariances, epsilon, with_trunc=True)
    Ct, trunc_ct = regularized_covariances(tx, tm, k_covariances, epsilon, with_trunc=True)

    if _use_cells(corr_backend, max_corr_dist, source, target):
        table = cell_list.build(tx, tm, np.float32(max_corr_dist),
                                table_size=table_size, cap=cell_cap)

        def find(src_t):
            idx_k, d2g, valid_k, trunc = cell_list.knn_radius(table, src_t, cand_k,
                                                              r=max_corr_dist)
            idxc = torch.clamp(idx_k.long(), 0, tx.shape[0] - 1)
            dlab = s_lab[:, None, :] - t_lab[idxc]                  # [N, k, 3]
            d6 = torch.where(valid_k, d2g + torch.sum(dlab * dlab, dim=-1), math.inf)
            d6_best, best = torch.min(d6, dim=1, keepdim=True)      # first on a tie
            idx = torch.gather(idx_k, 1, best)[:, 0]
            d2_geo = torch.gather(d2g, 1, best)[:, 0]
            d2 = torch.where(torch.isfinite(d6_best[:, 0]), d2_geo, math.inf)
            return idx, d2, torch.any(trunc & sm)
    else:
        # the colour channels do not move with T: appended after the transform
        t6 = torch.cat([tx, t_lab], dim=1)
        max_d2 = float(np.float32(max_corr_dist) ** 2)
        no_trunc = torch.zeros((), dtype=torch.bool, device=sx.device)

        def find(src_t):
            idx, _ = bruteforce.nn1(t6, tm, torch.cat([src_t, s_lab], dim=1))
            idxc = torch.clamp(idx.long(), 0, tx.shape[0] - 1)
            d2_geo = torch.sum((src_t - tx[idxc]) ** 2, dim=-1)
            return idx, torch.where(d2_geo <= max_d2, d2_geo, math.inf), no_trunc

    return _gicp_loop(source, target, init_transform, find, Cs, Ct, trunc_cs | trunc_ct,
                      max_iterations, inner_iterations, transformation_eps)
