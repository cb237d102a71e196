"""Iterative Closest Point — the canonical registration loop.

Counterpart of ``pcl_tpu/registration/icp.py``. Each iteration matches the
transformed source to the target (brute-force 1-NN through the CUDA kernel,
or the cell list for a finite gate on large pairs), estimates an increment
and tests convergence. The JAX package runs the loop as one
``lax.while_loop``; here it is a Python loop whose state stays on the
device, and the loop condition is the one value read back per iteration.

Variants: ``"point_to_point"`` (Umeyama), ``"point_to_plane"`` (target
normals) and ``"symmetric"`` (source and target normals). Convergence codes
are the ``CONV_*`` constants below.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.core.transforms import transform_cloud, transform_points
from pcl_tpu_torch.octree.linear import morton_encode
from pcl_tpu_torch.registration import correspondence as corr_mod
from pcl_tpu_torch.registration import estimation
from pcl_tpu_torch.search import cell_list

# convergence_state codes
CONV_RUNNING = 0
CONV_ITERATIONS = 1
CONV_TRANSFORM = 2
CONV_ABS_MSE = 3
CONV_REL_MSE = 4
CONV_FAILED_CORRESPONDENCES = -1


class ICPResult(NamedTuple):
    transform: torch.Tensor            # [4,4] final source -> target transform
    converged: torch.Tensor            # bool
    iterations: torch.Tensor           # int32
    fitness: torch.Tensor              # f32 mean squared correspondence distance
    num_correspondences: torch.Tensor  # int32 at the final iteration
    convergence_state: torch.Tensor    # int32 CONV_* code
    truncated: torch.Tensor            # bool: a cell-list bucket overflowed at
                                       # some iteration (correspondences may
                                       # not be nearest; raise cell_cap).
                                       # Always False on the brute backend.


def _gather(tgt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tgt[torch.clamp(idx.long(), 0, tgt.shape[0] - 1)]


def _masked_mse(c: corr_mod.Correspondences) -> torch.Tensor:
    """Mean squared distance over the valid correspondences. An unmatched
    point's distance may be +inf, so the mask selects rather than weighs
    (XLA turns the JAX package's ``sum(w * d2)`` into the same select)."""
    num = torch.sum(torch.where(c.valid, c.sqdist, 0.0))
    return num / torch.clamp(torch.sum(c.valid.to(torch.float32)), min=1.0)


def _sort_source(table: cell_list.CellTable, sx: torch.Tensor, sm: torch.Tensor,
                 grid_dims, max_corr_dist: float) -> torch.Tensor:
    """Permutation that makes spatially adjacent queries adjacent: the dense
    table's own row id, or morton order of 2r cells for a hash table. Masked
    points go last; ties keep their order."""
    if grid_dims is not None:
        key = cell_list._dense_id(cell_list._query_coords(table, sx), grid_dims)
    else:
        lo = torch.amin(torch.where(sm[:, None], sx, float("inf")), dim=0)
        cell0 = torch.clamp(
            xla_int32(torch.floor((sx - lo) / float(np.float32(2.0 * max_corr_dist)))),
            0, 1023)
        key = morton_encode(cell0)
    key = torch.where(sm, key, 2 ** 31 - 1)
    return torch.argsort(key, stable=True)


def icp(
    source: Cloud,
    target: Cloud,
    init_transform: Optional[torch.Tensor] = None,
    *,
    max_corr_dist: float = math.inf,
    max_iterations: int = 50,
    transformation_eps: float = 0.0,
    abs_mse_eps: float = 1e-12,
    rel_mse_eps: float = 1e-8,
    variant: str = "point_to_point",
    reciprocal: bool = False,
    min_correspondences: int = 3,
    corr_backend: str = "auto",
    cell_cap: int = 32,
    table_size: int = 1 << 17,
    grid_dims=None,
    index: Optional[cell_list.CellTable] = None,
) -> ICPResult:
    """Align ``source`` onto ``target``; returns the 4x4 transform and stats.

    ``transformation_eps`` bounds both the squared translation and
    ``1 - cos`` of the rotation of an increment. The brute backend serves
    an infinite gate, reciprocal matching, and pairs of at most 1e8
    candidate pairs; otherwise (or with ``corr_backend="cell"`` or a
    prebuilt ``index``) the cell list serves a finite gate, on the dense grid
    ``grid_dims`` when given (pick ~ceil(extent / (2 max_corr_dist)) + 1 per
    axis) and on the hash table otherwise.
    """
    dev = source.xyz.device
    if init_transform is None:
        init_transform = torch.eye(4, dtype=torch.float32, device=dev)
    if index is not None and reciprocal:
        raise ValueError("reciprocal=True is incompatible with a prebuilt "
                         "index (cell backend is one-way NN)")
    if variant not in ("point_to_point", "point_to_plane", "symmetric"):
        raise ValueError(f"unknown icp variant {variant!r}")
    if variant in ("point_to_plane", "symmetric") and ATTR_NORMAL not in target.attrs:
        raise ValueError(f"icp variant {variant!r} requires target normals")
    if variant == "symmetric" and ATTR_NORMAL not in source.attrs:
        raise ValueError("symmetric icp requires source normals")

    sx, sm = source.xyz, source.mask
    tx, tm = target.xyz, target.mask
    tn = target.attrs.get(ATTR_NORMAL)
    sn = source.attrs.get(ATTR_NORMAL)

    finite_gate = bool(np.isfinite(max_corr_dist))
    big = source.capacity * target.capacity > 1e8
    use_cells = (index is not None) or (corr_backend == "cell") or (
        corr_backend == "auto" and finite_gate and big and not reciprocal)
    if use_cells:
        if not finite_gate:
            raise ValueError("corr_backend='cell' requires finite max_corr_dist")
        if index is not None:
            table = index
            if table.dims is not None:
                grid_dims = table.dims
        else:
            table = build_index(target, max_corr_dist, cell_cap=cell_cap,
                                table_size=table_size, grid_dims=grid_dims)
        # the estimation reductions are permutation-invariant
        order = _sort_source(table, sx, sm, grid_dims, max_corr_dist)
        sx, sm = sx[order], sm[order]
        if sn is not None:
            sn = sn[order]

        def det(src_t: torch.Tensor) -> Tuple[corr_mod.Correspondences, torch.Tensor, Optional[torch.Tensor]]:
            idx, d2, trunc, dst = cell_list.nn1_radius(
                table, src_t, max_corr_dist, compact=True, with_dst=True)
            valid = sm & torch.isfinite(d2)
            # truncation matters only where a valid query looked
            return corr_mod.Correspondences(idx, d2, valid), torch.any(trunc & sm), dst
    else:
        match = corr_mod.determine_reciprocal_correspondences if reciprocal \
            else corr_mod.determine_correspondences
        no_trunc = torch.zeros((), dtype=torch.bool, device=dev)

        def det(src_t):
            return match(src_t, sm, tx, tm, max_corr_dist), no_trunc, None

    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    T = init_transform.to(device=dev, dtype=torch.float32)
    mse = torch.full((), math.inf, dtype=torch.float32, device=dev)
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)
    code = torch.full((), CONV_RUNNING, dtype=torch.int32, device=dev)
    trunc = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iterations:
        src_t = transform_points(T, sx)
        c, trunc_new, dst = det(src_t)
        w = c.valid.to(torch.float32)
        n_corr = torch.sum(c.valid.to(torch.int32))
        if dst is None:
            dst = _gather(tx, c.index)
        # rows without a match may carry garbage winner coordinates; they
        # weigh nothing, but the reductions need them finite
        dst = torch.where(c.valid[:, None], dst, 0.0)
        if variant == "point_to_point":
            T_delta = estimation.estimate_svd(src_t, dst, w)
        elif variant == "point_to_plane":
            T_delta = estimation.estimate_point_to_plane(src_t, dst, _gather(tn, c.index), w)
        else:
            sn_t = sn @ T[:3, :3].T
            T_delta = estimation.estimate_symmetric_point_to_plane(
                src_t, sn_t, dst, _gather(tn, c.index), w)
        mse_new = _masked_mse(c)
        ok = n_corr >= min_correspondences            # too few: freeze
        T_delta = torch.where(ok, T_delta, eye4)
        T = T_delta @ T
        it += 1
        # convergence tests on the increment (DefaultConvergenceCriteria)
        t2 = torch.sum(T_delta[:3, 3] ** 2)
        cos_r = torch.clamp((torch.trace(T_delta[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        small_transform = (t2 <= transformation_eps) & ((1.0 - cos_r) <= transformation_eps) \
            & (transformation_eps > 0.0)
        diff = torch.abs(mse_new - mse)
        abs_ok = (diff < abs_mse_eps) & (it > 1)
        rel_ok = (diff < rel_mse_eps * torch.abs(mse)) & (it > 1)
        tail = CONV_ITERATIONS if it >= max_iterations else CONV_RUNNING
        code = torch.where(~ok, CONV_FAILED_CORRESPONDENCES,
               torch.where(small_transform, CONV_TRANSFORM,
               torch.where(abs_ok, CONV_ABS_MSE,
               torch.where(rel_ok, CONV_REL_MSE, tail)))).to(torch.int32)
        mse = mse_new
        trunc = trunc | trunc_new
        if int(code) != CONV_RUNNING:                 # the one read-back
            break
    return ICPResult(
        transform=T,
        converged=code > 0,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        fitness=mse,
        num_correspondences=n_corr,
        convergence_state=code,
        truncated=trunc,
    )


def build_index(
    target: Cloud,
    max_corr_dist: float,
    *,
    cell_cap: int = 32,
    table_size: int = 1 << 17,
    grid_dims=None,
) -> cell_list.CellTable:
    """Prebuild the target's cell list for ``icp(..., index=...)``, with
    cells of ``2 * max_corr_dist`` for the 8-cell search; reuse it only with
    the same gate."""
    return cell_list.build(
        target.xyz, target.mask, np.float32(2.0 * max_corr_dist),
        table_size=table_size, cap=cell_cap, dims=grid_dims,
    )


def fitness_score(
    source: Cloud, target: Cloud, transform: torch.Tensor, max_range: float = math.inf
) -> torch.Tensor:
    """Mean squared distance from the transformed source to its nearest
    target points within ``max_range``."""
    src_t = transform_points(transform, source.xyz)
    c = corr_mod.determine_correspondences(src_t, source.mask, target.xyz,
                                           target.mask, max_range)
    return _masked_mse(c)


def align(source: Cloud, target: Cloud, **kw):
    """Run ICP and return ``(aligned source cloud, ICPResult)``."""
    res = icp(source, target, **kw)
    return transform_cloud(res.transform, source), res
