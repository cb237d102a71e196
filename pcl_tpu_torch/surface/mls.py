"""Moving least squares smoothing: batched local polynomial fits.

Counterpart of ``pcl_tpu/surface/mls.py`` (PCL's MovingLeastSquares). Per
point: its neighbours within ``search_radius`` (at most ``k``, the brute
radius search), an unweighted plane through them (centroid and the smallest
eigenvector of ``eigh33``), an order-2 (or order-1) height polynomial over
the plane's ``(u, v)`` frame fitted with Gaussian weights about the query's
plane foot (one batched 6x6 or 3x3 solve), and the query moved onto the
polynomial at ``(0, 0)``; the normal is the polynomial's. Points with fewer
neighbours than terms stay where they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.search import bruteforce

_EPS = 1e-12


def poly_coeffs(rel: torch.Tensor, w: torch.Tensor, e_u: torch.Tensor, e_v: torch.Tensor,
                nrm: torch.Tensor, order: int) -> torch.Tensor:
    """Weighted least-squares height polynomial ``[Q, nt]`` over the
    neighbours' offsets ``rel [Q, k, 3]`` from the plane foot, in the frame
    ``(e_u, e_v, nrm)``: ``(P^T W P + 1e-8 I) c = P^T W h``."""
    u = torch.einsum("nki,ni->nk", rel, e_u)
    v = torch.einsum("nki,ni->nk", rel, e_v)
    hgt = torch.einsum("nki,ni->nk", rel, nrm)
    one = torch.ones_like(u)
    terms = torch.stack([one, u, v, u * u, u * v, v * v] if order == 2 else [one, u, v], dim=-1)
    nt = terms.shape[-1]
    Pw = terms * w[..., None]
    A = torch.einsum("nkt,nks->nts", Pw, terms)
    A = A + 1e-8 * torch.eye(nt, dtype=A.dtype, device=A.device)
    b = torch.einsum("nkt,nk->nt", Pw, hgt)
    # no error check (it would read back): a singular system gives non-finite
    # coefficients, as the JAX package's solve does
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def moving_least_squares(
    cloud: Cloud,
    search_radius: float,
    *,
    k: int = 48,
    polynomial_order: int = 2,
    sqr_gauss_param: Optional[float] = None,
    compute_normals: bool = True,
) -> Cloud:
    """Project every point onto its local MLS surface: a cloud with the
    smoothed positions and, with ``compute_normals``, the MLS ``normal`` and
    ``curvature`` (the plane fit's smallest eigenvalue over the trace)."""
    if polynomial_order not in (1, 2):
        raise ValueError("polynomial_order must be 1 or 2")
    r32 = np.float32(search_radius)
    h2 = float(np.float32(sqr_gauss_param) if sqr_gauss_param is not None else r32 * r32)
    xyz, mask = cloud.xyz, cloud.mask
    n = cloud.capacity
    idx, _, valid, count = bruteforce.radius(xyz, mask, xyz, search_radius, cap=k)
    valid = valid & mask[:, None]
    nbr = xyz[torch.clamp(idx.long(), 0, n - 1)]

    # unweighted plane fit, as the reference's (mls.hpp: the Gaussian weights
    # enter the polynomial only)
    vf = valid.to(torch.float32)
    csum = torch.clamp(torch.sum(vf, dim=1), min=_EPS)
    mu = torch.einsum("nk,nki->ni", vf, nbr) / csum[:, None]
    dc = torch.where(valid[..., None], nbr - mu[:, None, :], 0.0)
    cov = torch.einsum("nk,nki,nkj->nij", vf, dc, dc) / csum[:, None, None]
    lam, V = geometry.eigh33(cov)
    nrm = V[..., :, 0]
    to_pt = xyz - mu
    flip = torch.sum(nrm * to_pt, dim=-1) < 0
    nrm = torch.where(flip[:, None], -nrm, nrm)
    e_u, e_v = V[..., :, 2], V[..., :, 1]

    # the polynomial about the query's plane foot, weighted by the distances
    # to it (mls.hpp re-derives them after the projection)
    foot = xyz - torch.sum(to_pt * nrm, dim=-1)[:, None] * nrm
    rel = nbr - foot[:, None, :]
    w = torch.where(valid, torch.exp(-torch.sum(rel * rel, dim=-1) / h2), 0.0)
    coeffs = poly_coeffs(rel, w, e_u, e_v, nrm, polynomial_order)
    nt = coeffs.shape[-1]

    enough = (count >= nt) & mask
    new_xyz = torch.where(enough[:, None], foot + coeffs[:, 0:1] * nrm, xyz)
    out = cloud.with_xyz(torch.where(mask[:, None], new_xyz, 0.0))
    if compute_normals:
        mls_n = nrm - coeffs[:, 1:2] * e_u - coeffs[:, 2:3] * e_v
        mls_n = mls_n / torch.clamp(torch.linalg.vector_norm(mls_n, dim=-1, keepdim=True),
                                    min=_EPS)
        mls_n = torch.where(mask[:, None], torch.where(enough[:, None], mls_n, nrm), 0.0)
        curv = lam[:, 0] / torch.clamp(lam.sum(dim=1), min=_EPS)
        curv = torch.where(mask & enough, curv, 0.0)
        out = out.with_attrs(**{ATTR_NORMAL: mls_n, "curvature": curv})
    return out
