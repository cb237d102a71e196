"""RoPS: rotational projection statistics.

Counterpart of ``pcl_tpu/features/rops.py`` (PCL's ROPSEstimation): the
local surface, expressed in a local reference frame, is rotated about each
axis by a few angles and projected on the xy, xz and yz planes; each
projection's distribution matrix gives four central moments and its Shannon
entropy, 3 axes x 3 rotations x 3 planes x 5 = 135 values by default.

- ``estimate_rops`` rotates the neighbourhood points in SHOT's frame;
- ``estimate_rops_mesh`` follows PCL on a triangle mesh: the frame from the
  area- and distance-weighted triangle scatter, the local points binned over
  each rotated bounding box. Points and triangles are packed to fixed caps
  by one stable sort each, where the JAX package takes ``lax.top_k`` and so
  lists equal values lowest index first (ROADMAP C8, C46).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import Cloud, _device
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.features.shot import _f32, _scatter_rows, local_reference_frames
from pcl_tpu_torch.search import bruteforce

_EPS = 1e-12


def _rot(axis_idx: int, angle: torch.Tensor) -> torch.Tensor:
    """3x3 rotation about coordinate axis ``axis_idx`` by ``angle`` (rad)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    if axis_idx == 0:
        rows = [[o, z, z], [z, c, -s], [z, s, c]]
    elif axis_idx == 1:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    else:
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _entropy(D: torch.Tensor, dims) -> torch.Tensor:
    return -torch.sum(torch.where(D > 0, D * torch.log(torch.clamp(D, min=_EPS)), 0.0),
                      dim=dims)


def _plane_stats(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, grid: int = 8
                 ) -> torch.Tensor:
    """Weighted central moments mu11, mu12, mu21, mu22 of the projection
    ``(u, v)`` and the entropy of its ``grid x grid`` occupancy over its
    bounding box: ``[N, k] -> [N, 5]``."""
    wsum = torch.clamp(torch.sum(w, dim=1), min=_EPS)
    du = u - (torch.sum(w * u, dim=1) / wsum)[:, None]
    dv = v - (torch.sum(w * v, dim=1) / wsum)[:, None]
    m11 = torch.sum(w * du * dv, dim=1) / wsum
    m12 = torch.sum(w * du * dv * dv, dim=1) / wsum
    m21 = torch.sum(w * du * du * dv, dim=1) / wsum
    m22 = torch.sum(w * du * du * dv * dv, dim=1) / wsum
    on = w > 0
    lo_u = torch.amin(torch.where(on, u, torch.inf), dim=1)
    hi_u = torch.amax(torch.where(on, u, -torch.inf), dim=1)
    lo_v = torch.amin(torch.where(on, v, torch.inf), dim=1)
    hi_v = torch.amax(torch.where(on, v, -torch.inf), dim=1)
    su = torch.clamp(hi_u - lo_u, min=_EPS)[:, None]
    sv = torch.clamp(hi_v - lo_v, min=_EPS)[:, None]
    bu = torch.clamp(torch.nan_to_num((u - lo_u[:, None]) / su * grid).to(torch.int64),
                     0, grid - 1)
    bv = torch.clamp(torch.nan_to_num((v - lo_v[:, None]) / sv * grid).to(torch.int64),
                     0, grid - 1)
    D = _scatter_rows(bu * grid + bv, w, grid * grid) / wsum[:, None]
    return torch.stack([m11, m12, m21, m22, _entropy(D, 1)], dim=-1)


def _central_moments(D: torch.Tensor) -> torch.Tensor:
    """PCL's computeCentralMoments: 1-based bin-index central moments mu11,
    mu21, mu12, mu22 and the entropy of ``D [..., b, b]`` -> ``[..., 5]``."""
    b = D.shape[-1]
    i = torch.arange(1, b + 1, dtype=torch.float32, device=D.device)
    mean_i = torch.einsum("...ij,i->...", D, i)
    mean_j = torch.einsum("...ij,j->...", D, i)
    fi = i[:, None] - mean_i[..., None, None]
    fj = i[None, :] - mean_j[..., None, None]
    mu11 = torch.sum(fi * fj * D, dim=(-2, -1))
    mu21 = torch.sum(fi * fi * fj * D, dim=(-2, -1))
    mu12 = torch.sum(fi * fj * fj * D, dim=(-2, -1))
    mu22 = torch.sum(fi * fi * fj * fj * D, dim=(-2, -1))
    return torch.stack([mu11, mu21, mu12, mu22, _entropy(D, (-2, -1))], dim=-1)


def _sqdist_rows(kp: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """``|kp|^2 - 2 kp.x + |x|^2`` (no clamp), the dot products and norms as
    chains of fused multiply-adds like the JAX package's compiled CPU code
    (``bruteforce._fma_sum``)."""
    fma = bruteforce._fma_sum
    return (fma(kp, kp)[:, None] - 2.0 * fma(kp[:, None, :], xyz[None, :, :])) \
        + fma(xyz, xyz)[None, :]


def _rops_mesh_chunk(xyz, tri, kp, support_radius, n_rotations, n_bins, cap_pts, cap_tri):
    r = _f32(support_radius)
    r2 = float(np.float32(r) ** 2)
    d2 = _sqdist_rows(kp, xyz)                                    # [Kc, N]
    member = d2 <= r2
    # the cap_pts nearest points, lowest index first on a tie
    sd2, pidx = torch.sort(d2, dim=1, stable=True)
    sd2, pidx = sd2[:, :cap_pts], pidx[:, :cap_pts]
    p_valid = sd2 <= r2
    overflow_pts = torch.sum(member, dim=1) > cap_pts
    # local triangles: any vertex inside the support, lowest index first
    tmask = member[:, tri[:, 0]] | member[:, tri[:, 1]] | member[:, tri[:, 2]]
    _, tidx = torch.sort((~tmask).to(torch.int8), dim=1, stable=True)
    tidx = tidx[:, :cap_tri]
    t_valid = torch.gather(tmask, 1, tidx)
    overflow_tri = torch.sum(tmask, dim=1) > cap_tri

    # the LRF: the area- and distance-weighted scatter of the local triangles
    verts = xyz[tri][tidx]                                        # [Kc, cap_tri, 3, 3]
    v = verts - kp[:, None, None, :]
    e1 = verts[..., 1, :] - verts[..., 0, :]
    e2 = verts[..., 2, :] - verts[..., 0, :]
    area = torch.where(t_valid, torch.linalg.vector_norm(_cross(e1, e2), dim=-1), 0.0)
    centroid = torch.mean(verts, dim=-2)
    dw = (r - torch.linalg.vector_norm(centroid - kp[:, None, :], dim=-1)) ** 2
    s = torch.sum(v, dim=-2)
    scatter = (torch.einsum("ktvi,ktvj->ktij", v, v)
               + torch.einsum("kti,ktj->ktij", s, s)) / 12.0
    total_area = torch.sum(area, dim=1)
    inv_area = torch.where(total_area < _EPS, 1.0, 1.0 / total_area)
    factor = torch.where(t_valid, dw * area * inv_area[:, None], 0.0)
    S = torch.einsum("kt,ktij->kij", factor, scatter)
    _, vecs = geometry.eigh33(S)
    v1, v3 = vecs[..., :, 2], vecs[..., :, 0]
    tw = factor / 6.0
    h1 = torch.sum(tw * torch.einsum("ktvi,ki->kt", v, v1), dim=1)
    h3 = torch.sum(tw * torch.einsum("ktvi,ki->kt", v, v3), dim=1)
    v1 = torch.where((h1 < 0)[:, None], -v1, v1)
    v3 = torch.where((h3 < 0)[:, None], -v3, v3)
    lrf = torch.stack([v1, _cross(v3, v1), v3], dim=-2)

    # the local points in the LRF, rotated, projected and binned
    pts = torch.einsum("kij,kpj->kpi", lrf, xyz[pidx] - kp[:, None, :])
    w = p_valid.to(torch.float32)
    count = torch.clamp(torch.sum(w, dim=1), min=1.0)
    step = 90.0 / (n_rotations + 1)
    big = 3.4e38
    feats = []
    for axis in range(3):
        for i_rot in range(1, n_rotations + 1):
            ang = torch.tensor(_f32(step * i_rot), device=xyz.device) * (math.pi / 180.0)
            p = torch.einsum("ij,kpj->kpi", _rot(axis, ang), pts)
            lo = torch.amin(torch.where(p_valid[..., None], p, big), dim=1)
            hi = torch.amax(torch.where(p_valid[..., None], p, -big), dim=1)
            for ui, vi in ((0, 1), (0, 2), (1, 2)):
                bl_u = torch.clamp((hi[:, ui] - lo[:, ui]) / n_bins, min=_EPS)
                bl_v = torch.clamp((hi[:, vi] - lo[:, vi]) / n_bins, min=_EPS)
                bu = torch.clamp(((p[..., ui] - lo[:, None, ui]) / bl_u[:, None])
                                 .to(torch.int64), 0, n_bins - 1)
                bv = torch.clamp(((p[..., vi] - lo[:, None, vi]) / bl_v[:, None])
                                 .to(torch.int64), 0, n_bins - 1)
                D = _scatter_rows(bu * n_bins + bv, w, n_bins * n_bins) / count[:, None]
                feats.append(_central_moments(D.reshape(-1, n_bins, n_bins)))
    out = torch.cat(feats, dim=-1)
    norm = torch.sum(out.abs(), dim=-1, keepdim=True)
    return out / torch.where(norm < _EPS, 1.0, norm), lrf, overflow_pts | overflow_tri


def estimate_rops_mesh(
    xyz,
    triangles,
    keypoint_indices,
    support_radius: float,
    *,
    n_rotations: int = 3,
    n_bins: int = 5,
    cap_pts: int = 512,
    cap_tri: int = 2048,
    chunk: int = 128,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCL's mesh RoPS at ``keypoint_indices``: ``(descriptors [K, 45 *
    n_rotations], lrfs [K, 3, 3], overflow [K])``, overflow where a cap cut
    the support. Keypoints run ``chunk`` at a time against the whole mesh.
    Tensors stay on their device; other inputs go to ``device`` (the card
    unless ``"cpu"``)."""
    dev = xyz.device if isinstance(xyz, torch.Tensor) else _device(device)
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
    tri = torch.as_tensor(np.asarray(triangles) if not isinstance(triangles, torch.Tensor)
                          else triangles, device=dev).long()
    kidx = torch.as_tensor(np.asarray(keypoint_indices) if not isinstance(
        keypoint_indices, torch.Tensor) else keypoint_indices, device=dev).long()
    kp_all = xyz[kidx]
    cap_pts = min(cap_pts, xyz.shape[0])
    cap_tri = min(cap_tri, tri.shape[0])
    parts = [_rops_mesh_chunk(xyz, tri, kp_all[i:i + chunk], support_radius, n_rotations,
                              n_bins, cap_pts, cap_tri)
             for i in range(0, kp_all.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def estimate_rops(
    cloud: Cloud,
    radius: float,
    *,
    k: int = 64,
    n_rotations: int = 3,
    grid: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPS of the neighbourhood points in SHOT's frame: ``(descriptors [N,
    45 * n_rotations], frames [N, 3, 3])``."""
    xyz, mask = cloud.xyz, cloud.mask
    idx, _, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    valid = valid & mask[:, None]
    nbr = xyz[idxc]
    frames, ok = local_reference_frames(xyz, nbr, valid, radius)
    rel = torch.einsum("nij,nkj->nki", frames, nbr - xyz[:, None, :]) / _f32(radius)
    w = valid.to(torch.float32)
    angles = (torch.arange(n_rotations, dtype=torch.float32, device=xyz.device) + 1.0) \
        / (n_rotations + 1.0) * (0.5 * math.pi)
    feats = []
    for axis in range(3):
        for ai in range(n_rotations):
            p = torch.einsum("ij,nkj->nki", _rot(axis, angles[ai]), rel)
            for u_i, v_i in ((0, 1), (0, 2), (1, 2)):
                feats.append(_plane_stats(p[..., u_i], p[..., v_i], w, grid))
    out = torch.cat(feats, dim=-1)
    return torch.where((mask & ok)[:, None], out, 0.0), frames
