"""SHOT descriptors: Signature of Histograms of OrienTations.

Counterpart of ``pcl_tpu/features/shot.py`` (PCL's SHOTEstimation,
SHOTColorEstimation and the SHOT local reference frame). SHOT352 is 32
spatial sectors (8 azimuth x 2 elevation x 2 radial shells) x 11 cosine
bins, L2-normalised; SHOT1344 appends 32 sectors x 31 bins of CIELab
distance.

- ``estimate_shot`` defaults to ``estimate_shot_interpolated``, PCL's
  quadrilinear interpolation with its LRF (radius-weighted covariance,
  majority sign with the median-window tie-break), bin layout and
  normalisation; ``estimate_shot_hard`` bins each neighbour once.
- The JAX package sums each histogram as a split one-hot matrix product, a
  TPU layout trick; here the weighted targets are added into their bins by
  ``ops.segsum.add_rows``, which adds duplicates in index order on both
  devices, so every run repeats its histograms bitwise (ROADMAP C28, C44,
  C84).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch import search as search_mod
from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, ATTR_RGB, Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.search import organized as org_mod

_EPS = 1e-12


def _f32(x) -> float:
    """``x`` rounded to float32, as the JAX package's traced scalars are."""
    return float(np.float32(x))


def _scatter_rows(targets: torch.Tensor, weights: torch.Tensor, nbins: int) -> torch.Tensor:
    """``[N, ...]`` bin targets and weights -> ``[N, nbins]`` sums, added in
    index order on both devices."""
    n = targets.shape[0]
    rows = torch.arange(n, device=targets.device).reshape((n,) + (1,) * (targets.ndim - 1))
    flat = (rows * nbins + targets.long()).reshape(-1)
    hist = weights.new_zeros(n * nbins)
    add_rows(hist, flat, weights.reshape(-1).to(hist.dtype))
    return hist.reshape(n, nbins)


def local_reference_frames(
    pts: torch.Tensor,          # [N, 3]
    nbr: torch.Tensor,          # [N, k, 3]
    nbr_valid: torch.Tensor,    # [N, k]
    radius: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched SHOT LRFs: ``(frames [N, 3, 3] rows = x, y, z axes, ok [N])``;
    x the largest eigenvector of the ``(r - d)``-weighted covariance, z the
    smallest, each signed towards the weighted neighbour directions."""
    d = nbr - pts[:, None, :]
    dist = torch.linalg.vector_norm(d, dim=-1)
    w = torch.where(nbr_valid, torch.clamp(_f32(radius) - dist, min=0.0), 0.0)
    wsum = torch.clamp(torch.sum(w, dim=1), min=_EPS)
    cov = torch.einsum("nk,nki,nkj->nij", w, d, d) / wsum[:, None, None]
    _, V = geometry.eigh33(cov)
    x, z = V[..., :, 2], V[..., :, 0]
    sx = torch.einsum("nk,nki,ni->n", w, d, x)
    x = torch.where((sx < 0)[:, None], -x, x)
    sz = torch.einsum("nk,nki,ni->n", w, d, z)
    z = torch.where((sz < 0)[:, None], -z, z)
    ok = torch.sum(nbr_valid, dim=1) >= 5
    return torch.stack([x, _cross(z, x), z], dim=-2), ok


def estimate_shot(
    cloud: Cloud,
    radius: float,
    k: int = 64,
    n_cos_bins: int = 11,
    backend: str = "auto",
    interpolated: bool = True,
    surface: Optional[Cloud] = None,
    cell_cap: Optional[int] = None,
) -> torch.Tensor:
    """SHOT descriptors ``[capacity, 352]``; requires normals. The default is
    the interpolated descriptor; ``interpolated=False`` or ``n_cos_bins``
    other than 11 takes the hard-binned variant (which ignores ``surface``)."""
    if interpolated and n_cos_bins == 11:
        return estimate_shot_interpolated(cloud, radius, k=k, backend=backend,
                                          surface=surface, cell_cap=cell_cap)
    return estimate_shot_hard(cloud, radius, k=k, n_cos_bins=n_cos_bins, backend=backend)


def _sectors(frames, rel, radius):
    """The hard variant's sector of each neighbour: 8 azimuth x 2 elevation
    x 2 radial shells, ``[N, k]`` in ``[0, 32)``."""
    local = torch.einsum("nai,nki->nka", frames, rel)
    dist = torch.linalg.vector_norm(rel, dim=-1)
    az = torch.atan2(local[..., 1], local[..., 0])
    az_bin = xla_int32(torch.clamp(torch.floor((az + math.pi) / (2 * math.pi) * 8), 0, 7)).long()
    el_bin = (local[..., 2] > 0).long()
    r_bin = (dist > _f32(radius) * 0.5).long()
    return (az_bin * 2 + el_bin) * 2 + r_bin


def _cos_bins(frames, nbr_n, n_cos_bins):
    cosang = torch.einsum("ni,nki->nk", frames[:, 2, :], nbr_n)
    return xla_int32(torch.clamp(torch.floor((cosang + 1.0) * 0.5 * n_cos_bins), 0,
                                 n_cos_bins - 1)).long()


def estimate_shot_hard(
    cloud: Cloud,
    radius: float,
    k: int = 64,
    n_cos_bins: int = 11,
    backend: str = "auto",
) -> torch.Tensor:
    """Hard-binned SHOT ``[capacity, 32 * n_cos_bins]``: each neighbour adds
    1 to its nearest bin. Requires normals."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("estimate_shot requires normals")
    xyz, mask = cloud.xyz, cloud.mask
    normals = cloud.attrs[ATTR_NORMAL]
    n = cloud.capacity
    idx, d2, valid, _ = search_mod.radius_search(cloud, xyz, radius, cap=k, backend=backend)
    idxc = torch.clamp(idx.long(), 0, n - 1)
    valid = valid & mask[:, None] & (d2 > 0)
    nbr = xyz[idxc]
    frames, ok = local_reference_frames(xyz, nbr, valid, radius)
    rel = nbr - xyz[:, None, :]
    joint = _sectors(frames, rel, radius) * n_cos_bins + _cos_bins(frames, normals[idxc],
                                                                   n_cos_bins)
    hist = _scatter_rows(joint, valid.to(torch.float32), 32 * n_cos_bins)
    out = hist / torch.clamp(torch.linalg.vector_norm(hist, dim=-1, keepdim=True), min=_EPS)
    return torch.where((mask & ok)[:, None], out, 0.0)


def _interp_neighbours(cloud: Cloud, src: Cloud, surface, radius, k, backend, cell_cap):
    """SHOT's neighbour lists, ascending: the organized window search for an
    organized self-query under ``backend="auto"``, else the search dispatch
    with cells ``radius`` wide and a bucket cap that tracks ``k``."""
    organized = (surface is None and cloud.height > 1 and cloud.width > 1
                 and cloud.width * cloud.height == cloud.capacity)
    if backend == "auto" and organized:
        H, W = cloud.height, cloud.width
        return org_mod.self_knn(cloud.xyz.reshape(H, W, 3), cloud.mask.reshape(H, W), k,
                                window=9 if k <= 24 else 13)
    cap = max(24, k) if cell_cap is None else cell_cap
    return search_mod.knn(src, cloud.xyz, k, backend=backend, cell_size=radius,
                          cell_cap=cap)[:3]


def estimate_shot_interpolated(
    cloud: Cloud,
    radius: float,
    k: int = 128,
    backend: str = "auto",
    surface: Optional[Cloud] = None,
    cell_cap: Optional[int] = None,
) -> torch.Tensor:
    """PCL's SHOT352 ``[capacity, 352]``: quadrilinear interpolation over
    the cosine, radial, inclination and azimuth bins with PCL's LRF, at most
    ``k`` nearest neighbours within ``radius``. ``surface`` is PCL's
    setSearchSurface: descriptors at ``cloud``'s points, neighbourhoods and
    normals from ``surface``. Rows with fewer than 5 LRF neighbours are 0."""
    src = surface if surface is not None else cloud
    if ATTR_NORMAL not in src.attrs:
        raise ValueError("estimate_shot requires normals")
    xyz, mask = cloud.xyz, cloud.mask
    normals = src.attrs[ATTR_NORMAL]
    n = src.capacity
    nb = 10                                 # cosine bins - 1 (the descriptor is 32 x 11)
    idx, d2, valid = _interp_neighbours(cloud, src, surface, radius, k, backend, cell_cap)
    r = np.float32(radius)
    r2 = float(r * r)
    # invalid lanes may carry inf: keep the masked weights below finite
    d2 = torch.where(torch.isfinite(d2), d2, 4.0 * r2)
    valid = valid & (d2 <= r2) & mask[:, None]
    idxc = torch.clamp(idx.long(), 0, n - 1)
    vij = src.xyz[idxc] - xyz[:, None, :]
    nrm_nbr = normals[idxc]
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    okn = valid & (d2 > 0.0)                # the query itself excluded

    # the LRF: (r - d)-weighted covariance, x the largest eigenvector, z the
    # smallest, each signed by a majority of the neighbours with PCL's tie-break
    w = torch.where(okn, float(r) - d, 0.0)
    cov = torch.einsum("nk,nki,nkj->nij", w, vij, vij)
    _, V = geometry.eigh33(cov)
    nvalid = torch.sum(okn, dim=1)

    def disamb(v):
        dp = torch.einsum("nki,ni->nk", vij, v)
        plus = torch.sum((dp >= 0) & okn, dim=1)
        s = 2 * plus - nvalid
        # a tie goes to the 5 neighbours around the median of the ascending
        # list (the list holds the query at position 0, hence the + 1)
        med = nvalid // 2 + 1
        pos = torch.clamp(med[:, None] - torch.arange(-2, 3, device=dp.device)[None, :],
                          0, dp.shape[1] - 1)
        tie_flip = torch.sum(torch.gather(dp, 1, pos) > 0, dim=1) < 3
        flip = (s < 0) | ((s == 0) & tie_flip)
        return torch.where(flip[:, None], -v, v)

    v1 = disamb(V[..., :, 2])
    v3 = disamb(V[..., :, 0])
    v2 = _cross(v3, v1)

    # local coordinates and the volume (sector) of each neighbour
    xf = torch.einsum("nki,ni->nk", vij, v1)
    yf = torch.einsum("nki,ni->nk", vij, v2)
    zf = torch.einsum("nki,ni->nk", vij, v3)
    bit4 = ((yf > 0) | ((yf == 0) & (xf < 0))).long()
    bit3 = torch.where((xf > 0) | ((xf == 0) & (yf > 0)), 1 - bit4, bit4)
    desc = (bit4 << 4) + (bit3 << 3)
    cond = (xf * yf > 0) | (xf == 0.0)
    desc = desc + torch.where(cond, torch.where(xf.abs() >= yf.abs(), 0, 4),
                              torch.where(xf.abs() > yf.abs(), 4, 0))
    desc = desc + (zf > 0).long()
    r12 = float(r / np.float32(2.0))
    r14 = float(r / np.float32(4.0))
    r34 = float(np.float32(3.0) * r / np.float32(4.0))
    desc = desc + 2 * (d > r12).long()
    vol = desc * (nb + 1)

    # the cosine bin and its interpolation
    cosD = torch.clamp(torch.einsum("nki,ni->nk", nrm_nbr, v3), -1.0, 1.0)
    binDist = (1.0 + cosD) * nb / 2.0
    step = xla_int32(torch.floor(binDist + 0.5)).long()
    frac = binDist - step
    cos_target = torch.where(frac > 0, vol + (step + 1) % nb, vol + (step - 1 + nb) % nb)
    cos_w = frac.abs()
    intW = 1.0 - frac.abs()

    # radial interpolation
    outer = d > r12
    rd_out = (d - r34) / r12
    rd_in = (d - r14) / r12
    rad_target = torch.where(outer, desc - 2, desc + 2) * (nb + 1) + step
    rad_w = torch.where(outer, torch.where(d > r34, 0.0, -rd_out),
                        torch.where(d < r14, 0.0, rd_in))
    intW = intW + torch.where(outer, torch.where(d > r34, 1.0 - rd_out, 1.0 + rd_out),
                              torch.where(d < r14, 1.0 + rd_in, 1.0 - rd_in))

    # inclination interpolation
    incl = torch.arccos(torch.clamp(zf / torch.clamp(d, min=_EPS), -1.0, 1.0))
    q = math.pi / 2.0
    upper = (incl > q) | (((incl - q).abs() < 1e-30) & (zf <= 0))
    id_up = (incl - 3.0 * math.pi / 4.0) / q
    id_lo = (incl - math.pi / 4.0) / q
    inc_target = torch.where(upper, desc + 1, desc - 1) * (nb + 1) + step
    inc_w = torch.where(upper, torch.where(incl > 3.0 * math.pi / 4.0, 0.0, -id_up),
                        torch.where(incl < math.pi / 4.0, 0.0, id_lo))
    intW = intW + torch.where(
        upper, torch.where(incl > 3.0 * math.pi / 4.0, 1.0 - id_up, 1.0 + id_up),
        torch.where(incl < math.pi / 4.0, 1.0 + id_lo, 1.0 - id_lo))

    # azimuth interpolation
    az_on = (yf != 0.0) | (xf != 0.0)
    azim = torch.atan2(yf, xf)
    sel = desc >> 2
    azd = (azim - (-math.pi * 7.0 / 8.0 + (math.pi / 4.0) * sel)) / (math.pi / 4.0)
    azd = torch.clamp(azd, -0.5, 0.5)
    az_target = torch.where(azd > 0, (desc + 4) % 32, (desc - 4 + 32) % 32) * (nb + 1) + step
    az_w = torch.where(az_on, azd.abs(), 0.0)
    intW = intW + torch.where(az_on, 1.0 - azd.abs(), 0.0)

    T = torch.stack([vol + step, cos_target, rad_target, inc_target, az_target], dim=-1)
    W = torch.stack([intW, cos_w, rad_w, inc_w, az_w], dim=-1) * okn[..., None]
    hist = _scatter_rows(torch.clamp(T, 0, 351), W, 352)
    out = hist / torch.clamp(torch.linalg.vector_norm(hist, dim=-1, keepdim=True), min=_EPS)
    # fewer than 5 LRF neighbours: PCL's frame is NaN, the row 0 here
    return torch.where((mask & (nvalid >= 5))[:, None], out, 0.0)


def _rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> CIELab (D65), ``[..., 3] -> [..., 3]``."""
    c = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    M = torch.tensor([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]], dtype=torch.float32, device=rgb.device)
    white = torch.tensor([0.95047, 1.0, 1.08883], dtype=torch.float32, device=rgb.device)
    t = (c @ M.T) / white
    # a float64 cube root rounded once to float32 (torch has no cbrt)
    cbrt = (torch.clamp(t, min=0.0).double() ** (1.0 / 3.0)).to(torch.float32)
    f = torch.where(t > 0.008856, cbrt, 7.787 * t + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def estimate_shot_color(
    cloud: Cloud,
    radius: float,
    k: int = 64,
    n_cos_bins: int = 11,
    n_color_bins: int = 31,
) -> torch.Tensor:
    """SHOT colour descriptors ``[capacity, 32 * (n_cos_bins +
    n_color_bins)]`` (1344): the hard-binned shape histogram and 32 sectors x
    ``n_color_bins`` bins of the CIELab L1 distance between the query and each
    neighbour, L2-normalised together. Requires normals and rgb."""
    if ATTR_NORMAL not in cloud.attrs or ATTR_RGB not in cloud.attrs:
        raise ValueError("estimate_shot_color requires normals and rgb")
    xyz, mask = cloud.xyz, cloud.mask
    normals = cloud.attrs[ATTR_NORMAL]
    lab = _rgb_to_lab(cloud.attrs[ATTR_RGB])
    n = cloud.capacity
    idx, d2, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, n - 1)
    valid = valid & mask[:, None] & (d2 > 0)
    nbr = xyz[idxc]
    frames, ok = local_reference_frames(xyz, nbr, valid, radius)
    sector = _sectors(frames, nbr - xyz[:, None, :], radius)
    w = valid.to(torch.float32)
    shape_hist = _scatter_rows(sector * n_cos_bins + _cos_bins(frames, normals[idxc],
                                                               n_cos_bins),
                               w, 32 * n_cos_bins)
    # (|dL| / 100 + (|da| / 120 + |db| / 120) / 2) / 3, clamped to [0, 1]
    nbr_lab = lab[idxc]
    dl = (nbr_lab[..., 0] - lab[:, None, 0]).abs() / 100.0
    da = (nbr_lab[..., 1] - lab[:, None, 1]).abs() / 120.0
    db = (nbr_lab[..., 2] - lab[:, None, 2]).abs() / 120.0
    ldist = torch.clamp((dl + (da + db) * 0.5) / 3.0, 0.0, 1.0)
    col_bin = xla_int32(torch.clamp(torch.floor(ldist * n_color_bins), 0, n_color_bins - 1)).long()
    color_hist = _scatter_rows(sector * n_color_bins + col_bin, w, 32 * n_color_bins)
    out = torch.cat([shape_hist, color_hist], dim=-1)
    out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=_EPS)
    return torch.where((mask & ok)[:, None], out, 0.0)
