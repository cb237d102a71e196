"""Pose-graph optimisation: LUM global alignment and ELCH loop closing.

Counterpart of ``pcl_tpu/registration/graph.py``. LUM (PCL's
``pcl::registration::LUM``) minimises ``sum_edges sum_k |T_i p_k - T_j q_k|^2``
over all absolute poses by Gauss-Newton on se(3) twists, vertex 0 held by a
1e12 prior: every edge's correspondences are padded ``[E, C, 3]`` tensors, the
6x6 blocks of all edges come from one reduction each, and the ``6V x 6V``
normal system is either assembled dense and solved by LU, or solved by
block-Jacobi preconditioned conjugate gradients on edge-block products, which
never forms the ``[V, V, 6, 6]`` matrix. The JAX package runs the Gauss-Newton
iterations as one ``lax.while_loop``; here they are a Python loop over device
tensors that reads back one value an iteration, the residual its condition
tests, and CG keeps its fixed ``cg_iters`` with no read-back. Sums into
vertices use ``index_put_`` with accumulation, which adds duplicates in index
order on both devices (a stable sort on CUDA), so a run repeats bit for bit.

ELCH (``pcl::registration::ELCH``) spreads a loop-closure correction over the
chain, vertex k taking the fraction ``k / (V - 1)`` of its twist.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.core.transforms import se3_exp, se3_log, transform_points
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.registration.gicp import _skew


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor        # [V,4,4] optimised absolute poses
    iterations: torch.Tensor   # int32
    residual: torch.Tensor     # f32 mean squared edge residual at the last linearisation


def _edge_system(P, edge_src, edge_dst, corr_src, corr_dst, corr_valid):
    """Per-edge 6x6 blocks and gradients of the LUM objective linearised at
    ``P``: ``(H_ii, H_jj, H_ij [E,6,6], g_i, g_j [E,6], res)``."""
    pw = transform_points(P[edge_src], corr_src)            # [E,C,3]
    qw = transform_points(P[edge_dst], corr_dst)
    w = corr_valid.to(torch.float32)
    r = pw - qw
    # d r / d xi_i = [I | -[pw]x],  d r / d xi_j = -[I | -[qw]x]
    eye = torch.eye(3, dtype=torch.float32, device=P.device).expand(pw.shape[:2] + (3, 3))
    Ji = torch.cat([eye, -_skew(pw)], dim=-1)                # [E,C,3,6]
    Jj = -torch.cat([eye, -_skew(qw)], dim=-1)
    H_ii = torch.einsum("ec,ecka,eckb->eab", w, Ji, Ji)
    H_jj = torch.einsum("ec,ecka,eckb->eab", w, Jj, Jj)
    H_ij = torch.einsum("ec,ecka,eckb->eab", w, Ji, Jj)
    g_i = torch.einsum("ec,ecka,eck->ea", w, Ji, r)
    g_j = torch.einsum("ec,ecka,eck->ea", w, Jj, r)
    res = torch.sum(w * torch.sum(r * r, dim=-1)) / torch.clamp(torch.sum(w), min=1.0)
    return H_ii, H_jj, H_ij, g_i, g_j, res


def _block_jacobi_cg(matvec, b: torch.Tensor, diag_blocks: torch.Tensor, iters: int):
    """Block-Jacobi preconditioned conjugate gradients on the ``[V, 6]``
    system, ``iters`` steps. The blocks are inverted unchecked, as
    ``jnp.linalg.inv`` does."""
    Minv = torch.linalg.inv_ex(diag_blocks)[0]

    def prec(v):
        return torch.einsum("vab,vb->va", Minv, v)

    x = torch.zeros_like(b)
    r = b
    p = prec(r)
    rz = torch.sum(r * p)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
    return x


def lum(
    poses: torch.Tensor,          # [V,4,4] initial absolute poses
    edge_src: torch.Tensor,       # [E] int vertex i of each edge
    edge_dst: torch.Tensor,       # [E] int vertex j of each edge
    corr_src: torch.Tensor,       # [E,C,3] points in frame i
    corr_dst: torch.Tensor,       # [E,C,3] corresponding points in frame j
    corr_valid: torch.Tensor,     # [E,C] bool
    *,
    max_iterations: int = 5,
    convergence_threshold: float = 0.0,
    damping: float = 1e-6,
    solver: str = "dense",
    cg_iters: int = 48,
) -> PoseGraphResult:
    """Globally consistent alignment of V scans from inter-scan
    correspondences, pose 0 held fixed.

    ``solver='dense'`` factorises the ``6V x 6V`` system (PCL solves it with a
    QR; the ``[V, V, 6, 6]`` matrix is ``144 V^2`` bytes); ``'cg'`` runs
    block-Jacobi CG on edge-block products, ``O(E)`` memory. Iterations stop
    after ``max_iterations`` or once the residual at the current poses is no
    more than ``convergence_threshold``."""
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown lum solver {solver!r}")
    dev = poses.device
    V = poses.shape[0]
    es, ed = edge_src.long(), edge_dst.long()
    prior = torch.zeros((V, 6), dtype=torch.float32, device=dev)
    prior[0] = 1e12
    P = poses.to(torch.float32)
    res = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    it = 0
    while it < max_iterations and bool(res > convergence_threshold):   # the one read-back
        H_ii, H_jj, H_ij, g_i, g_j, res = _edge_system(P, es, ed, corr_src, corr_dst, corr_valid)
        g = add_rows(add_rows(torch.zeros((V, 6), dtype=torch.float32, device=dev),
                              es, g_i), ed, g_j)
        D = add_rows(add_rows(torch.zeros((V, 6, 6), dtype=torch.float32, device=dev),
                              es, H_ii), ed, H_jj)
        tr = torch.einsum("vaa->", D) / (6.0 * V)
        damp = damping * (tr + 1.0)
        if solver == "dense":
            H = torch.zeros((V, V, 6, 6), dtype=torch.float32, device=dev)
            add_rows(H, (es, es), H_ii)
            add_rows(H, (ed, ed), H_jj)
            add_rows(H, (es, ed), H_ij)
            add_rows(H, (ed, es), H_ij.transpose(-1, -2))
            Hf = H.permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
            del H
            Hf.diagonal().add_(prior.reshape(-1) + damp)
            dx = -torch.linalg.solve_ex(Hf, g.reshape(-1, 1))[0].reshape(V, 6)
            del Hf
        else:
            def matvec(x):
                xi, xj = x[es], x[ed]
                yi = torch.einsum("eab,eb->ea", H_ii, xi) + torch.einsum("eab,eb->ea", H_ij, xj)
                yj = torch.einsum("eba,eb->ea", H_ij, xi) + torch.einsum("eab,eb->ea", H_jj, xj)
                y = add_rows(add_rows(torch.zeros_like(x), es, yi), ed, yj)
                return y + (prior + damp) * x

            Dp = D + torch.diag_embed(prior + damp)
            dx = -_block_jacobi_cg(matvec, g, Dp, cg_iters)
        P = se3_exp(dx) @ P
        it += 1
    return PoseGraphResult(poses=P, iterations=torch.tensor(it, dtype=torch.int32, device=dev),
                           residual=res)


def elch_distribute(poses: torch.Tensor, loop_transform: torch.Tensor) -> torch.Tensor:
    """Distribute a loop-closure correction over the chain ``0 .. V-1``:
    vertex k is corrected by ``exp(k / (V - 1) * log(loop_transform))``."""
    V = poses.shape[0]
    xi = se3_log(loop_transform.to(torch.float32))
    wgt = torch.arange(V, dtype=torch.float32, device=poses.device) / max(V - 1.0, 1.0)
    corr = se3_exp(wgt[:, None] * xi)                        # [V,4,4]
    return torch.einsum("vij,vjk->vik", corr, poses.to(torch.float32))


def build_edges_from_correspondences(pairs, max_corr: int, device=None):
    """Host helper: a list of ``(i, j, src_pts [C_e,3], dst_pts [C_e,3])`` ->
    padded tensors for ``lum`` on ``device`` (default CUDA): ``(edge_src,
    edge_dst, corr_src, corr_dst, corr_valid)``; an edge keeps its first
    ``max_corr`` pairs."""
    dev = _device(device)
    E = len(pairs)
    es = np.zeros(E, np.int32)
    ed = np.zeros(E, np.int32)
    cs = np.zeros((E, max_corr, 3), np.float32)
    cd = np.zeros((E, max_corr, 3), np.float32)
    cv = np.zeros((E, max_corr), bool)
    for e, (i, j, s, d) in enumerate(pairs):
        s, d = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in (s, d))
        c = min(len(s), max_corr)
        es[e], ed[e] = i, j
        cs[e, :c] = s[:c]
        cd[e, :c] = d[:c]
        cv[e, :c] = True
    return tuple(torch.from_numpy(a).to(dev) for a in (es, ed, cs, cd, cv))
