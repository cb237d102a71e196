"""Colour pair features: PFHRGB, PPFRGB and CPPF.

Counterpart of ``pcl_tpu/features/color_features.py`` (PCL's
PFHRGBEstimation, PPFRGBEstimation and CPPFEstimation): the PFH joint
histogram of a k-neighbourhood beside one of per-channel colour ratios
binned alike (250 bins); the four PPF values with three colour ratios for a
pair; and per (point, neighbour) pair the PPF values, the point's colour and
the colour ratios.
"""

from __future__ import annotations

import math

import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, ATTR_RGB, Cloud
from pcl_tpu_torch.features.fpfh import _bin_index, _soft_hist, pair_features
from pcl_tpu_torch.registration.ppf import ppf_features
from pcl_tpu_torch.search import bruteforce

_EPS = 1e-9


def _color_ratios(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Per channel ``min(c1, c2) / max(c1, c2)`` in ``[0, 1]``."""
    hi = torch.clamp(torch.maximum(c1, c2), min=_EPS)
    return torch.clamp(torch.minimum(c1, c2), min=0.0) / hi


def _needs(cloud: Cloud, what: str):
    if ATTR_NORMAL not in cloud.attrs or ATTR_RGB not in cloud.attrs:
        raise ValueError(f"{what} requires normals and rgb")
    return cloud.attrs[ATTR_NORMAL], cloud.attrs[ATTR_RGB]


def estimate_pfhrgb(cloud: Cloud, k: int = 10, nr_subdiv: int = 5) -> torch.Tensor:
    """PFHRGB ``[capacity, 2 nr_subdiv^3]``: the geometric PFH histogram and
    the colour-ratio histogram over the same pairs, each summing to 100."""
    nrm, rgb = _needs(cloud, "estimate_pfhrgb")
    idx, _, valid = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, k)
    valid = valid & cloud.mask[:, None]
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    pp, nn, cc = cloud.xyz[idxc], nrm[idxc], rgb[idxc]
    f1, f2, f3, _, ok = pair_features(pp[:, :, None, :], nn[:, :, None, :],
                                      pp[:, None, :, :], nn[:, None, :, :])
    iu = torch.ones((k, k), dtype=torch.bool, device=idx.device).triu(1)
    w = (valid[:, :, None] & valid[:, None, :] & ok & iu[None]).to(torch.float32)
    npairs = torch.clamp(torch.sum(w, dim=(-2, -1)), min=1.0)
    nb = nr_subdiv ** 3
    geo = _bin_index(f1, -math.pi, math.pi, nr_subdiv) + nr_subdiv * (
        _bin_index(f2, -1.0, 1.0, nr_subdiv) + nr_subdiv * _bin_index(f3, -1.0, 1.0, nr_subdiv))
    flatw = (100.0 * w / npairs[:, None, None]).reshape(w.shape[0], -1)
    ratios = _color_ratios(cc[:, :, None, :], cc[:, None, :, :])
    cb = [_bin_index(ratios[..., c], 0.0, 1.0, nr_subdiv) for c in range(3)]
    col = cb[0] + nr_subdiv * (cb[1] + nr_subdiv * cb[2])
    out = torch.cat([_soft_hist(geo.reshape(geo.shape[0], -1), flatw, nb),
                     _soft_hist(col.reshape(col.shape[0], -1), flatw, nb)], dim=1)
    return torch.where(cloud.mask[:, None], out, 0.0)


def ppfrgb_features(p1, n1, c1, p2, n2, c2):
    """``(f1, f2, f3, f4, r, g, b ratios)`` of point pairs."""
    f1, f2, f3, f4 = ppf_features(p1, n1, p2, n2)
    rat = _color_ratios(c1, c2)
    return f1, f2, f3, f4, rat[..., 0], rat[..., 1], rat[..., 2]


def estimate_cppf(cloud: Cloud, k: int = 10) -> torch.Tensor:
    """CPPF rows ``[capacity, k, 10]`` per (point, neighbour): the four PPF
    values, the point's colour and the colour ratios (zero rows where the
    neighbour is invalid)."""
    nrm, rgb = _needs(cloud, "estimate_cppf")
    idx, _, valid = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, k + 1)
    idx, valid = idx[:, 1:], valid[:, 1:] & cloud.mask[:, None]
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    c2 = rgb[idxc]
    c1 = rgb[:, None, :]
    f1, f2, f3, f4 = ppf_features(cloud.xyz[:, None, :], nrm[:, None, :], cloud.xyz[idxc],
                                  nrm[idxc])
    rows = torch.cat([torch.stack([f1, f2, f3, f4], dim=-1), c1 * torch.ones_like(c2),
                      _color_ratios(c1, c2)], dim=-1)
    return torch.where(valid[..., None], rows, 0.0)
