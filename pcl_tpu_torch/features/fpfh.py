"""PFH and FPFH descriptors as batched histogram reductions.

Counterpart of ``pcl_tpu/features/fpfh.py``: every (point, neighbour) pair
feature of a ``[N, k]`` neighbourhood is computed in one batch, binned, and
summed into histograms; FPFH then adds the neighbours' SPFH rows weighted by
``1 / d^2``. Layouts as in PCL: FPFH is 33 bins (11 each for theta in
``[-pi, pi]``, alpha and phi in ``[-1, 1]``), each block summing to 100; PFH
is the joint ``nr_subdiv^3`` histogram summing to 100. The JAX package bins
with a one-hot matrix product; here ``scatter_add_`` adds the same weights
into the same bins.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.search import hashgrid as hashgrid_mod

_EPS = 1e-12


def pair_features(p1: torch.Tensor, n1: torch.Tensor, p2: torch.Tensor, n2: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """Darboux-frame pair features of broadcastable ``[..., 3]`` inputs:
    ``(f1 theta, f2 alpha, f3 phi, f4 distance, ok)``, zero where not ok."""
    d = p2 - p1
    f4 = torch.sqrt(torch.sum(d * d, dim=-1))
    ok = f4 > 0.0
    inv = 1.0 / torch.clamp(f4, min=_EPS)
    angle1 = torch.sum(n1 * d, dim=-1) * inv
    angle2 = torch.sum(n2 * d, dim=-1) * inv
    # the point whose normal is better aligned with the connecting line is
    # the source
    swap = torch.abs(angle1) < torch.abs(angle2)
    sw = swap[..., None]
    n1c = torch.where(sw, n2, n1)
    n2c = torch.where(sw, n1, n2)
    dc = torch.where(sw, -d, d)
    f3 = torch.where(swap, -angle2, angle1)
    v = _cross(dc, n1c)
    v_norm = torch.sqrt(torch.sum(v * v, dim=-1))
    ok = ok & (v_norm > 0.0)
    v = v / torch.clamp(v_norm, min=_EPS)[..., None]
    w = _cross(n1c, v)
    f2 = torch.sum(v * n2c, dim=-1)
    f1 = torch.atan2(torch.sum(w * n2c, dim=-1), torch.sum(n1c * n2c, dim=-1))
    return (torch.where(ok, f1, 0.0), torch.where(ok, f2, 0.0), torch.where(ok, f3, 0.0),
            torch.where(ok, f4, 0.0), ok)


def _bin_index(f: torch.Tensor, lo: float, hi: float, nbins: int) -> torch.Tensor:
    idx = xla_int32(torch.floor(nbins * (f - lo) / (hi - lo))).to(torch.int64)
    return torch.clamp(idx, 0, nbins - 1)


def _soft_hist(bin_idx: torch.Tensor, weights: torch.Tensor, nbins: int) -> torch.Tensor:
    """``[..., k]`` bins and weights -> ``[..., nbins]`` histogram."""
    out = weights.new_zeros(weights.shape[:-1] + (nbins,))
    return out.scatter_add_(-1, bin_idx, weights)


def spfh_from_neighborhoods(pts: torch.Tensor, nrm: torch.Tensor, nbr_idx: torch.Tensor,
                            nbr_valid: torch.Tensor, surf_xyz: torch.Tensor,
                            surf_nrm: torch.Tensor, nbins: int = 11) -> torch.Tensor:
    """SPFH histograms ``[N, 3 * nbins]``, each block summing to 100 over the
    valid neighbours other than the point itself."""
    idx = torch.clamp(nbr_idx.long(), 0, surf_xyz.shape[0] - 1)
    f1, f2, f3, f4, ok = pair_features(pts[:, None, :], nrm[:, None, :], surf_xyz[idx],
                                       surf_nrm[idx])
    w = (nbr_valid & ok & (f4 > 0.0)).to(torch.float32)
    cnt = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    incr = 100.0 * w / cnt
    return torch.cat([_soft_hist(_bin_index(f1, -math.pi, math.pi, nbins), incr, nbins),
                      _soft_hist(_bin_index(f2, -1.0, 1.0, nbins), incr, nbins),
                      _soft_hist(_bin_index(f3, -1.0, 1.0, nbins), incr, nbins)], dim=-1)


def fpfh_from_spfh(spfh: torch.Tensor, nbr_idx: torch.Tensor, nbr_d2: torch.Tensor,
                   nbr_valid: torch.Tensor, nbins: int = 11) -> torch.Tensor:
    """The neighbours' SPFH rows weighted by ``1 / d^2`` (the point itself,
    at ``d = 0``, excluded), each block renormalised to 100."""
    idx = torch.clamp(nbr_idx.long(), 0, spfh.shape[0] - 1)
    valid = nbr_valid & (nbr_d2 > 0.0)
    wgt = torch.where(valid, 1.0 / torch.clamp(nbr_d2, min=_EPS), 0.0)
    acc = torch.einsum("nk,nkb->nb", wgt, spfh[idx])
    out = []
    for b in range(3):
        blk = acc[:, b * nbins:(b + 1) * nbins]
        s = torch.sum(blk, dim=-1, keepdim=True)
        out.append(torch.where(s > 0, 100.0 * blk / torch.clamp(s, min=_EPS), blk))
    return torch.cat(out, dim=-1)


def _neighbours(cloud: Cloud, k: int, backend: str, cell_size: Optional[float]):
    if backend == "hashgrid":
        if cell_size is None:
            raise ValueError("hashgrid backend requires cell_size")
        grid = hashgrid_mod.build(cloud.xyz, cloud.mask, cell_size)
        idx, d2, valid, _ = hashgrid_mod.knn(grid, cloud.xyz, k)
    else:
        idx, d2, valid = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, k)
    return idx, d2, valid & cloud.mask[:, None]


def _normals(cloud: Cloud, what: str) -> torch.Tensor:
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError(f"{what} requires normals")
    return cloud.attrs[ATTR_NORMAL]


def estimate_fpfh(cloud: Cloud, k: int = 16, nbins: int = 11, backend: str = "bruteforce",
                  cell_size: Optional[float] = None) -> torch.Tensor:
    """FPFH descriptors ``[capacity, 3 * nbins]`` of every valid point (zero
    rows elsewhere) from k-NN neighbourhoods; the cloud must carry normals.
    ``backend="hashgrid"`` takes the hash grid with cells ``cell_size`` wide."""
    nrm = _normals(cloud, "estimate_fpfh")
    idx, d2, valid = _neighbours(cloud, k, backend, cell_size)
    spfh = spfh_from_neighborhoods(cloud.xyz, nrm, idx, valid, cloud.xyz, nrm, nbins)
    fpfh = fpfh_from_spfh(spfh, idx, d2, valid, nbins)
    return torch.where(cloud.mask[:, None], fpfh, 0.0)


def estimate_pfh(cloud: Cloud, k: int = 10, nr_subdiv: int = 5, backend: str = "bruteforce",
                 cell_size: Optional[float] = None) -> torch.Tensor:
    """PFH descriptors ``[capacity, nr_subdiv^3]``: the joint histogram over
    every unordered pair of the k-neighbourhood (the point included, as its
    own neighbour at distance 0), bin ``f1 + nr (f2 + nr f3)``."""
    nrm = _normals(cloud, "estimate_pfh")
    idx, _, valid = _neighbours(cloud, k, backend, cell_size)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    pp, nn = cloud.xyz[idxc], nrm[idxc]
    f1, f2, f3, _, ok = pair_features(pp[:, :, None, :], nn[:, :, None, :],
                                      pp[:, None, :, :], nn[:, None, :, :])
    kk = idx.shape[1]
    iu = torch.ones((kk, kk), dtype=torch.bool, device=idx.device).triu(1)
    w = (valid[:, :, None] & valid[:, None, :] & ok & iu[None]).to(torch.float32)
    npairs = torch.clamp(torch.sum(w, dim=(-2, -1)), min=1.0)
    joint = _bin_index(f1, -math.pi, math.pi, nr_subdiv) + nr_subdiv * (
        _bin_index(f2, -1.0, 1.0, nr_subdiv) + nr_subdiv * _bin_index(f3, -1.0, 1.0, nr_subdiv))
    flatw = (100.0 * w / npairs[:, None, None]).reshape(w.shape[0], -1)
    hist = _soft_hist(joint.reshape(joint.shape[0], -1), flatw, nr_subdiv ** 3)
    return torch.where(cloud.mask[:, None], hist, 0.0)
