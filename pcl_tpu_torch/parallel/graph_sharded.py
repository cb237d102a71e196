"""Sharded pose-graph solve: LUM's edges split over the ranks.

Counterpart of ``pcl_tpu/parallel/graph_sharded.py``. The edge
correspondence sets (``[E, C, 3]``, the big tensors) are split over the ranks,
padded to a multiple of the axis size with edges of no valid correspondence
(exact no-ops); the poses ``[V, 4, 4]`` and the CG state ``[V, 6]`` are whole
on every rank. Each Gauss-Newton iteration:

- each rank forms the 6x6 blocks of its edges (``graph._edge_system``) and
  sums them into its vertices;
- one all-reduce of the gradient and the block diagonal (the JAX package
  makes two, of ``[V, 6]`` and ``[V, 6, 6]``; here one buffer of ``42 V``
  floats);
- block-Jacobi CG where each matrix-vector product is the rank's edge
  products plus one all-reduce of ``[V, 6]``;
- the same pose update on every rank.

All-reduces per Gauss-Newton iteration: ``cg_iters + 1``, independent of the
correspondence count. Fixed ``max_iterations`` and ``cg_iters``, with no
read-back, as in the JAX package.
"""

from __future__ import annotations

import torch

from pcl_tpu_torch.core.transforms import se3_exp
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.parallel.mesh import POINTS_AXIS, Axis, Mesh, _psum, _shard
from pcl_tpu_torch.registration.graph import (
    PoseGraphResult,
    _block_jacobi_cg,
    _edge_system,
)


def sharded_lum(
    mesh: Mesh,
    poses,            # [V,4,4] initial absolute poses
    edge_src,         # [E] int
    edge_dst,         # [E] int
    corr_src,         # [E,C,3]
    corr_dst,         # [E,C,3]
    corr_valid,       # [E,C] bool
    *,
    max_iterations: int = 5,
    damping: float = 1e-6,
    cg_iters: int = 48,
    axis: Axis = POINTS_AXIS,
) -> PoseGraphResult:
    """LUM global alignment with the edges split over ``mesh``: the optimised
    poses, the same on every rank. Padding edges (to a multiple of the axis
    size) carry no valid correspondence."""
    dev = mesh.device
    # padding edges join vertex 0 to itself with nothing valid
    es, ed = (_shard(mesh, torch.as_tensor(e), axis).long() for e in (edge_src, edge_dst))
    cs, cd, cv = (_shard(mesh, torch.as_tensor(c), axis)
                  for c in (corr_src, corr_dst, corr_valid))
    P = torch.as_tensor(poses, dtype=torch.float32).to(dev)
    V = P.shape[0]
    prior = torch.zeros((V, 6), dtype=torch.float32, device=dev)
    prior[0] = 1e12
    for _ in range(max_iterations):
        H_ii, H_jj, H_ij, g_i, g_j, _res = _edge_system(P, es, ed, cs, cd, cv)
        g = add_rows(add_rows(torch.zeros((V, 6), dtype=torch.float32, device=dev),
                              es, g_i), ed, g_j)
        D = add_rows(add_rows(torch.zeros((V, 6, 6), dtype=torch.float32, device=dev),
                              es, H_ii), ed, H_jj)
        gD = _psum(mesh, torch.cat([g.reshape(-1), D.reshape(-1)]), axis)
        g, D = gD[:6 * V].reshape(V, 6), gD[6 * V:].reshape(V, 6, 6)
        tr = torch.einsum("vaa->", D) / (6.0 * V)
        damp = damping * (tr + 1.0)

        def matvec(x, H_ii=H_ii, H_jj=H_jj, H_ij=H_ij, damp=damp):
            xi, xj = x[es], x[ed]
            yi = torch.einsum("eab,eb->ea", H_ii, xi) + torch.einsum("eab,eb->ea", H_ij, xj)
            yj = torch.einsum("eba,eb->ea", H_ij, xi) + torch.einsum("eab,eb->ea", H_jj, xj)
            y = add_rows(add_rows(torch.zeros_like(x), es, yi), ed, yj)
            # the one collective of a CG step: [V, 6]
            return _psum(mesh, y, axis) + (prior + damp) * x

        dx = -_block_jacobi_cg(matvec, g, D + torch.diag_embed(prior + damp), cg_iters)
        P = se3_exp(dx) @ P
    # the residual at the final poses
    *_blocks, res_local = _edge_system(P, es, ed, cs, cd, cv)
    w = torch.sum(cv.to(torch.float32))
    s = _psum(mesh, torch.stack([w, res_local * torch.clamp(w, min=1.0)]), axis)
    return PoseGraphResult(poses=P, iterations=torch.tensor(max_iterations, dtype=torch.int32,
                                                            device=dev),
                           residual=s[1] / torch.clamp(s[0], min=1.0))
