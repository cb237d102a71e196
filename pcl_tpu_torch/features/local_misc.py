"""Assorted local features: principal curvatures, boundary points, spin
images, difference of normals, moment of inertia and moment invariants.

Counterpart of ``pcl_tpu/features/local_misc.py`` (PCL's
PrincipalCurvaturesEstimation, BoundaryEstimation, SpinImageEstimation,
DifferenceOfNormalsEstimation, MomentOfInertiaEstimation and
MomentInvariantsEstimation). ``spin_images`` bins each neighbour once;
``spin_images_reference`` is PCL's bilinear form with its border rules,
support angle and the three domains.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.features.normals import estimate_normals
from pcl_tpu_torch.features.shot import _f32, _scatter_rows
from pcl_tpu_torch.search import bruteforce

_EPS = 1e-12


def _normals_of(cloud: Cloud, what: str) -> torch.Tensor:
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError(f"{what} requires normals")
    return cloud.attrs[ATTR_NORMAL]


def principal_curvatures(cloud: Cloud, k: int = 16
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(pc1 [N], pc2 [N], direction [N, 3])``: the two largest eigenvalues
    of the covariance of the neighbours' normals projected on the tangent
    plane, and the eigenvector of the largest."""
    normals = _normals_of(cloud, "principal_curvatures")
    xyz, mask = cloud.xyz, cloud.mask
    idx, _, valid = bruteforce.knn(xyz, mask, xyz, k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    w = (valid & mask[:, None]).to(torch.float32)
    nn = normals[idxc]
    proj = nn - torch.einsum("nki,ni->nk", nn, normals)[..., None] * normals[:, None, :]
    wsum = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mu = torch.einsum("nk,nki->ni", w, proj) / wsum[:, None]
    d = proj - mu[:, None, :]
    cov = torch.einsum("nk,nki,nkj->nij", w, d, d) / wsum[:, None, None]
    lam, V = geometry.eigh33(cov)
    return (torch.where(mask, lam[:, 2], 0.0), torch.where(mask, lam[:, 1], 0.0),
            torch.where(mask[:, None], V[..., :, 2], 0.0))


def boundary_estimation(cloud: Cloud, radius: float, angle_threshold: float = math.pi / 2,
                        k: int = 48) -> torch.Tensor:
    """``[N]`` bool: the largest angular gap between consecutive neighbours
    in the tangent plane exceeds ``angle_threshold`` (or fewer than 3
    neighbours)."""
    normals = _normals_of(cloud, "boundary_estimation")
    xyz, mask = cloud.xyz, cloud.mask
    n = cloud.capacity
    idx, d2, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, n - 1)
    valid = valid & mask[:, None] & (d2 > 0)
    rel = xyz[idxc] - xyz[:, None, :]
    ex = torch.tensor([1.0, 0.0, 0.0], device=xyz.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=xyz.device)
    a = torch.where((normals[:, 0:1].abs() < 0.9), ex, ey)
    u = _cross(normals, a)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=_EPS)
    v = _cross(normals, u)
    ang = torch.atan2(torch.einsum("nki,ni->nk", rel, v), torch.einsum("nki,ni->nk", rel, u))
    ang_sorted = torch.sort(torch.where(valid, ang, torch.inf), dim=1)[0]
    cnt = torch.sum(valid, dim=1)
    gap = torch.roll(ang_sorted, -1, dims=1) - ang_sorted
    lane = torch.arange(k, device=xyz.device)
    last = torch.gather(ang_sorted, 1, torch.clamp(cnt - 1, 0, k - 1)[:, None])[:, 0]
    wrap = 2 * math.pi - (last - ang_sorted[:, 0])
    gap = torch.where(lane[None, :] == (cnt - 1)[:, None], wrap[:, None], gap)
    gap = torch.where(lane[None, :] < cnt[:, None], gap, -torch.inf)
    max_gap = torch.amax(gap, dim=1)
    return mask & ((max_gap > angle_threshold) | (cnt < 3))


def spin_images(cloud: Cloud, radius: float, image_width: int = 8, k: int = 64
                ) -> torch.Tensor:
    """Spin images ``[N, (w + 1) (2 w + 1)]`` (153 at width 8): each
    neighbour in its (radial distance from the normal axis, signed height)
    bin, rows summing to 1."""
    normals = _normals_of(cloud, "spin_images")
    xyz, mask = cloud.xyz, cloud.mask
    idx, _, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    valid = valid & mask[:, None]
    rel = xyz[idxc] - xyz[:, None, :]
    beta = torch.einsum("nki,ni->nk", rel, normals)
    alpha = torch.sqrt(torch.clamp(torch.sum(rel * rel, dim=-1) - beta * beta, min=0.0))
    r = _f32(radius)
    na, nb = image_width + 1, 2 * image_width + 1
    ab = torch.clamp((alpha / r * image_width).to(torch.int64), 0, na - 1)
    bb = torch.clamp(((beta / r + 1.0) * image_width).to(torch.int64), 0, nb - 1)
    hist = _scatter_rows(ab * nb + bb, valid.to(torch.float32), na * nb)
    s = torch.clamp(torch.sum(hist, dim=-1, keepdim=True), min=_EPS)
    return torch.where(mask[:, None], hist / s, 0.0)


def difference_of_normals(cloud: Cloud, k_small: int = 8, k_large: int = 32) -> torch.Tensor:
    """Difference of normals ``[N]``: ``|(n_small - n_large) / 2|``, the
    small-scale normal signed to agree with the large-scale one."""
    ns = estimate_normals(cloud, k=k_small).attrs[ATTR_NORMAL]
    nl = estimate_normals(cloud, k=k_large).attrs[ATTR_NORMAL]
    ns = torch.where((torch.sum(ns * nl, dim=-1) < 0)[:, None], -ns, ns)
    return torch.where(cloud.mask, torch.linalg.vector_norm(0.5 * (ns - nl), dim=-1), 0.0)


class MomentsResult(NamedTuple):
    moment_of_inertia: torch.Tensor     # [S] over view directions
    eccentricity: torch.Tensor          # [S]
    aabb_min: torch.Tensor              # [3]
    aabb_max: torch.Tensor              # [3]
    obb_center: torch.Tensor            # [3]
    obb_extents: torch.Tensor           # [3] half sizes
    obb_rotation: torch.Tensor          # [3, 3] columns = OBB axes
    eigenvalues: torch.Tensor           # [3] descending
    eigenvectors: torch.Tensor          # [3, 3] columns, descending


def moment_of_inertia(cloud: Cloud, n_steps: int = 36) -> MomentsResult:
    """Global moments about ``n_steps`` axes between the major and middle
    axes, eccentricity, and the axis-aligned and oriented bounding boxes."""
    xyz, mask = cloud.xyz, cloud.mask
    w = mask.to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(xyz * w[:, None], dim=0) / wsum
    d = (xyz - mu) * w[:, None]
    cov = torch.einsum("ni,nj->ij", d, xyz - mu) / wsum
    lam, V = geometry.eigh33(cov)
    lam_desc = torch.flip(lam, dims=[0])
    V_desc = torch.flip(V, dims=[1])
    theta = torch.linspace(0, math.pi, n_steps, device=xyz.device)
    dirs = (torch.cos(theta)[:, None] * V_desc[None, :, 0]
            + torch.sin(theta)[:, None] * V_desc[None, :, 1])
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=_EPS)
    r2 = torch.sum(d * d, dim=-1)
    proj = torch.einsum("ni,si->ns", d, dirs)
    moi = torch.sum(r2[:, None] - proj ** 2, dim=0)
    ecc = torch.ones_like(moi) * torch.sqrt(
        torch.clamp(1.0 - lam_desc[1] / torch.clamp(lam_desc[0], min=_EPS), min=0.0))
    aabb_min = torch.amin(torch.where(mask[:, None], xyz, torch.inf), dim=0)
    aabb_max = torch.amax(torch.where(mask[:, None], xyz, -torch.inf), dim=0)
    local = torch.einsum("ni,ij->nj", xyz - mu, V_desc)
    lmin = torch.amin(torch.where(mask[:, None], local, torch.inf), dim=0)
    lmax = torch.amax(torch.where(mask[:, None], local, -torch.inf), dim=0)
    return MomentsResult(
        moment_of_inertia=moi, eccentricity=ecc, aabb_min=aabb_min, aabb_max=aabb_max,
        obb_center=mu + V_desc @ ((lmin + lmax) * 0.5), obb_extents=(lmax - lmin) * 0.5,
        obb_rotation=V_desc, eigenvalues=lam_desc, eigenvectors=V_desc)


def moment_invariants(cloud: Cloud, radius: float, k: int = 32) -> torch.Tensor:
    """Moment invariants ``[N, 3]`` = (j1, j2, j3) of each neighbourhood's
    central second moments."""
    xyz, mask = cloud.xyz, cloud.mask
    idx, _, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    w = (valid & mask[:, None]).to(torch.float32)
    wsum = torch.clamp(torch.sum(w, dim=1), min=1.0)
    nbr = xyz[idxc]
    mu = torch.einsum("nk,nki->ni", w, nbr) / wsum[:, None]
    d = nbr - mu[:, None, :]
    m = torch.einsum("nk,nki,nkj->nij", w, d, d)
    mu200, mu020, mu002 = m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]
    mu110, mu101, mu011 = m[:, 0, 1], m[:, 0, 2], m[:, 1, 2]
    j1 = mu200 + mu020 + mu002
    j2 = (mu200 * mu020 + mu200 * mu002 + mu020 * mu002
          - mu110 ** 2 - mu101 ** 2 - mu011 ** 2)
    j3 = (mu200 * mu020 * mu002 + 2.0 * mu110 * mu101 * mu011
          - mu002 * mu110 ** 2 - mu020 * mu101 ** 2 - mu200 * mu011 ** 2)
    return torch.where(mask[:, None], torch.stack([j1, j2, j3], dim=-1), 0.0)


def spin_images_reference(
    cloud: Cloud,
    radius: float,
    image_width: int = 8,
    support_angle_cos: float = 0.0,
    k: int = 256,
    radial: bool = False,
    angular: bool = False,
    min_pts: int = 1,
) -> torch.Tensor:
    """PCL's spin images ``[capacity, (w + 1) (2 w + 1)]``: cylindrical
    (alpha, beta) about the normal, bilinear votes with PCL's border rules,
    the support-angle filter and the rectangular, radial or angular domain,
    flattened alpha-row-major."""
    nrm = _normals_of(cloud, "spin_images_reference")
    xyz, mask = cloud.xyz, cloud.mask
    n = cloud.capacity
    w = image_width
    r = _f32(radius)
    idx, d2, valid = bruteforce.knn(xyz, mask, xyz, k)
    valid = valid & (d2 <= float(np.float32(r) ** 2)) & mask[:, None]
    idxc = torch.clamp(idx.long(), 0, n - 1)
    n_neigh = torch.sum(valid, dim=1)            # the point itself included
    cosbn = torch.clamp(torch.einsum("ni,nki->nk", nrm, nrm[idxc]), -1.0, 1.0)
    keep = valid
    if support_angle_cos > 0.0 or angular:
        keep = keep & (cosbn.abs() >= _f32(support_angle_cos))
    direction = xyz[idxc] - xyz[:, None, :]
    dn = torch.sqrt(torch.clamp(d2, min=0.0))
    keep = keep & (d2 > 0.0)
    cda = torch.clamp(torch.einsum("nki,ni->nk", direction, nrm) / torch.clamp(dn, min=1e-30),
                      -1.0, 1.0)
    if radial:
        bin_size = _f32(r / np.float32(w))
        beta = torch.arcsin(cda)
        alpha = dn
        beta_bin_size = math.pi / 2.0 / w
    else:
        bin_size = _f32(np.float32(r) / np.float32(w) / np.float32(np.sqrt(2.0)))
        beta = dn * cda
        alpha = dn * torch.sqrt(torch.clamp(1.0 - cda * cda, min=0.0))
        edge = _f32(np.float32(bin_size) * np.float32(w))
        keep = keep & (beta.abs() < edge) & (alpha < edge)
        beta_bin_size = bin_size
    bbin = xla_int32(torch.floor(beta / beta_bin_size)).to(torch.int64) + w
    abin = xla_int32(torch.floor(alpha / bin_size)).to(torch.int64)
    a_border = abin == w
    b_border = bbin == 2 * w
    abin = torch.where(a_border, abin - 1, abin)
    bbin = torch.where(b_border, bbin - 1, bbin)
    a = torch.clamp(torch.where(a_border, 1.0, alpha / bin_size - abin), 0.0, 1.0)
    b = torch.clamp(torch.where(b_border, 1.0, beta / beta_bin_size - (bbin - w)), 0.0, 1.0)
    abin = torch.clamp(abin, 0, w - 1)
    bbin = torch.clamp(bbin, 0, 2 * w - 1)
    cols_n = 2 * w + 1
    t00 = abin * cols_n + bbin
    T = torch.stack([t00, t00 + cols_n, t00 + 1, t00 + cols_n + 1], dim=-1)
    kf = keep.to(torch.float32)
    W = torch.stack([(1 - a) * (1 - b) * kf, a * (1 - b) * kf, (1 - a) * b * kf, a * b * kf],
                    dim=-1)
    nb = (w + 1) * cols_n
    hist = _scatter_rows(T, W, nb)
    if angular:
        asum = _scatter_rows(T, W * torch.arccos(cosbn.abs())[..., None], nb)
        out = asum / (hist + 1e-16)
    else:
        s = torch.sum(hist, dim=1, keepdim=True)
        out = torch.where((n_neigh > 1)[:, None] & (s > 0), hist / torch.clamp(s, min=1e-30),
                          hist)
    return torch.where((mask & (n_neigh >= min_pts))[:, None], out, 0.0)
