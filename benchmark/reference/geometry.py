"""The plain reference of the odometry chain: voxel centroids, GICP's
covariances and the GICP aligner, in plain PyTorch.

Written from the algorithm's published description and the semantics that
the configuration and traffic state (the port's docstrings name the same):
nothing here imports the port. Every function computes in its inputs' dtype:
float64 for the reference, bfloat16 for the control (the reference computed
one precision below the port's float32; ``voxel_centroids`` takes the dtype
as an argument). Operations that PyTorch offers only in float32 and float64
(``eigh``, ``solve``, ``inv``) run in float32 on bfloat16 inputs and are
rounded back.

The aligner is GICP as the traffic runs it, with its stopping rule:
correspondences at the current pose, Gauss-Newton steps with those fixed,
until a step is shorter than the traffic's ``transformation_eps``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import search


def _lin(x: torch.Tensor) -> torch.Tensor:
    """An operand for ``linalg``: float32 where ``x`` is below it."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def eigh(a: torch.Tensor):
    """Batched symmetric eigendecomposition on the host (LAPACK): cuSOLVER's
    batched call refuses batches of the size of a scan."""
    lam, v = torch.linalg.eigh(_lin(a).cpu())
    return lam.to(device=a.device, dtype=a.dtype), v.to(device=a.device, dtype=a.dtype)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A small system solved on the host by least squares (SVD), so that a
    singular one (no correspondences left) gives the least-norm step."""
    x = torch.linalg.lstsq(_lin(a).cpu(), _lin(b).cpu(), driver="gelsd").solution
    return x.to(device=b.device, dtype=b.dtype)


def hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    a = torch.linalg.vector_norm(_lin(w)).to(w.dtype)
    K = hat(w / torch.clamp(a, min=1e-30))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(a) * K + (1 - torch.cos(a)) * (K @ K)


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return p @ T[:3, :3].T + T[:3, 3]


# ---------------------------------------------------------------- front end

def voxel_centroids(xyz32: torch.Tensor, leaf: float, dtype=torch.float64) -> torch.Tensor:
    """PCL's VoxelGrid: the centroid of the points of every occupied cell
    ``floor(x / leaf)``, the cell index computed in float32 as PCL computes it
    (``xyz32`` are the float32 points as sensed; in ``dtype`` where that is
    lower). ``[V, 3]`` in ``dtype``, in no particular order."""
    kd = torch.float32 if dtype in (torch.float32, torch.float64) else dtype
    keys = torch.floor(xyz32.to(kd) / torch.tensor(leaf, dtype=kd, device=xyz32.device))
    keys = keys.to(torch.int64)
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    n = int(inv.max()) + 1 if len(inv) else 0
    x = xyz32.to(dtype)
    sums = torch.zeros((n, 3), dtype=dtype, device=x.device).index_add_(0, inv, x)
    cnt = torch.zeros((n,), dtype=dtype, device=x.device).index_add_(
        0, inv, torch.ones_like(x[:, 0]))
    return sums / cnt[:, None]


def gicp_covariances(xyz: torch.Tensor, k: int, cell: float, eps: float = 1e-3):
    """Segal et al.'s plane-to-plane covariances: ``V diag(eps, 1, 1) V^T`` in
    the eigenbasis (ascending) of the covariance of the ``k`` nearest points;
    the identity where fewer than 3 neighbours exist."""
    idx, _ = search.knn(xyz, xyz, k, cell)
    nbr = xyz[torch.clamp(idx, min=0)]
    ok = (idx >= 0)[..., None].to(xyz.dtype)
    cnt = ok.sum(1)
    mu = (nbr * ok).sum(1) / torch.clamp(cnt, min=1)
    dx = (nbr - mu[:, None, :]) * ok
    cov = dx.transpose(1, 2) @ dx / torch.clamp(cnt, min=1)[..., None]
    _, V = eigh(cov)
    d = torch.tensor([eps, 1.0, 1.0], dtype=xyz.dtype, device=xyz.device)
    C = torch.einsum("nik,k,njk->nij", V, d, V)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand_as(C)
    return torch.where((cnt[:, 0] >= 3)[:, None, None], C, eye)


# ---------------------------------------------------------------- aligners

def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """The exponential of the twist ``xi = (v, w)``: ``[R(w) | V(w) v]``."""
    w = xi[3:]
    a = torch.linalg.vector_norm(_lin(w)).to(w.dtype)
    K = hat(w / torch.clamp(a, min=1e-30))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    if float(a) < 1e-12:
        V = eye
    else:
        V = eye + (1 - torch.cos(a)) / a * K + (a - torch.sin(a)) / a * (K @ K)
    D = torch.eye(4, dtype=xi.dtype, device=xi.device)
    D[:3, :3] = rodrigues(w)
    D[:3, 3] = V @ xi[:3]
    return D


def gicp(src, tgt, Cs, Ct, init, gate: float, max_iterations: int, inner_iterations: int,
         eps: float):
    """Generalized ICP (Segal, Haehnel, Thrun 2009): an outer
    iteration takes each source point's nearest target within ``gate`` at
    the current pose and fixes the information ``(C_t + R C_s R^T)^-1`` of
    each pair at the current rotation; then ``inner_iterations``
    Gauss-Newton steps on the left twist minimise ``sum d^T M d``. It stops
    once the last step's twist is shorter than ``eps``, or after
    ``max_iterations``. Returns ``(T, outer iterations)``."""
    T = init.to(src.dtype)
    eye3 = torch.eye(3, dtype=src.dtype, device=src.device)
    it = 0
    while it < max_iterations:
        idx, _ = search.nn1_within(tgt, apply(T, src), gate)
        ok = idx >= 0
        s, q, cs, ct = src[ok], tgt[idx[ok]], Cs[ok], Ct[idx[ok]]
        R = T[:3, :3]
        M = torch.linalg.inv(_lin(ct + R @ cs @ R.T)).to(src.dtype)
        for _ in range(inner_iterations):
            p = apply(T, s)
            J = torch.cat([eye3.expand(len(p), 3, 3), -hat(p)], 2)       # [N, 3, 6]
            MJ = M @ J
            H = torch.einsum("nai,naj->ij", J, MJ)
            g = torch.einsum("nai,na->i", MJ, p - q)
            xi = -solve(H, g[:, None])[:, 0]
            T = exp_se3(xi) @ T
        it += 1
        if float(torch.linalg.vector_norm(_lin(xi))) < eps:
            break
    return T, it


def gicp_cost(src, tgt, Cs, Ct, T, gate: float) -> float:
    """GICP's objective at ``T``: the mean over the matched points of
    ``d^T (C_t + R C_s R^T)^-1 d``, each point's nearest target within
    ``gate`` at ``T``."""
    idx, _ = search.nn1_within(tgt, apply(T, src), gate)
    ok = idx >= 0
    R = T[:3, :3]
    M = torch.linalg.inv(_lin(Ct[idx[ok]] + R @ Cs[ok] @ R.T)).to(src.dtype)
    d = apply(T, src[ok]) - tgt[idx[ok]]
    return float(torch.einsum("ni,nij,nj->n", d, M, d).mean())


def pose_gap(A: torch.Tensor, B: torch.Tensor):
    """Translation (m) and rotation (rad) between two 4x4 transforms."""
    A, B = A.double().cpu(), B.double().cpu()
    R = A[:3, :3] @ B[:3, :3].T
    skew = 0.5 * torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    ang = math.atan2(float(torch.linalg.vector_norm(skew)), 0.5 * (float(torch.trace(R)) - 1.0))
    return float(torch.linalg.vector_norm(A[:3, 3] - B[:3, 3])), ang
