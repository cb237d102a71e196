"""Global descriptors: VFH and ESF.

Counterpart of ``pcl_tpu/features/global_desc.py``:

- VFH (PCL's VFHEstimation, VFHSignature308): 4 x 45 bins of the Darboux
  pair features between the centroid with the mean normal and every point,
  then 128 bins of the angle between each normal and the viewpoint
  direction;
- ESF (PCL's ESFEstimation, ESFSignature640): 10 x 64 bins of shape
  functions over random point triples (D2 distances, split in and out by
  whether the midpoint lies near the cloud, D3 areas, A3 angles). ESF is a
  sampler and a core (ROADMAP C17, C50): ``draw_esf_samples`` draws the ``[3,
  n_samples]`` triples with ``torch.multinomial``, ``estimate_esf_core``
  takes them. The midpoints' 1-NN is ``bruteforce.nn1``, kernel B1 on the
  card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.core.geometry import _cross
from pcl_tpu_torch.features.fpfh import _bin_index, _soft_hist, pair_features
from pcl_tpu_torch.sac.ransac import categorical, generator
from pcl_tpu_torch.search import bruteforce

_EPS = 1e-12


def _hist(f: torch.Tensor, lo: float, hi: float, nbins: int, w: torch.Tensor) -> torch.Tensor:
    return _soft_hist(_bin_index(f, lo, hi, nbins)[None], w[None], nbins)[0]


def estimate_vfh(cloud: Cloud, viewpoint: Optional[torch.Tensor] = None, nbins_angle: int = 45,
                 nbins_vp: int = 128) -> torch.Tensor:
    """One VFH descriptor ``[4 nbins_angle + nbins_vp]`` (308): each of the
    four pair-feature blocks sums to 100, and so does the viewpoint block."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("estimate_vfh requires normals")
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    vp = torch.zeros(3, device=dev) if viewpoint is None \
        else torch.as_tensor(viewpoint, dtype=torch.float32, device=dev)
    normals = cloud.attrs[ATTR_NORMAL]
    w = mask.to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    centroid = torch.sum(xyz * w[:, None], dim=0) / wsum
    n_c = torch.sum(normals * w[:, None], dim=0) / wsum
    n_c = n_c / torch.clamp(torch.linalg.vector_norm(n_c), min=_EPS)
    f1, f2, f3, f4, ok = pair_features(centroid[None, :], n_c[None, :], xyz, normals)
    valid = mask & ok
    wv = valid.to(torch.float32)
    incr = 100.0 * wv / torch.clamp(torch.sum(wv), min=1.0)
    max_d = torch.amax(torch.where(valid, f4, 0.0))
    h1 = _hist(f1, -math.pi, math.pi, nbins_angle, incr)
    h2 = _hist(f2, -1.0, 1.0, nbins_angle, incr)
    h3 = _hist(f3, -1.0, 1.0, nbins_angle, incr)
    h4 = _hist(f4 / torch.clamp(max_d, min=_EPS), 0.0, 1.0, nbins_angle, incr)
    vdir = vp - centroid
    vdir = vdir / torch.clamp(torch.linalg.vector_norm(vdir), min=_EPS)
    hv = _hist(normals @ vdir, -1.0, 1.0, nbins_vp, incr * (nbins_vp / 100.0))
    hv = 100.0 * hv / torch.clamp(torch.sum(hv), min=_EPS)
    return torch.cat([h1, h2, h3, h4, hv])


def draw_esf_samples(mask: torch.Tensor, n_samples: int = 4096,
                     gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[3, n_samples]`` point indices, each drawn uniformly among the valid
    points (``gen`` seeded 0 on the mask's device unless given)."""
    return categorical(generator(mask.device, gen), mask, (3, n_samples))


def estimate_esf_core(cloud: Cloud, tri: torch.Tensor, nbins: int = 64) -> torch.Tensor:
    """ESF ``[10 nbins]`` (640) of the triples ``tri [3, S]``, each block
    summing to 100."""
    xyz, mask = cloud.xyz, cloud.mask
    tri = tri.to(xyz.device).long()
    n_samples = tri.shape[1]
    a, b, c = xyz[tri[0]], xyz[tri[1]], xyz[tri[2]]
    scale = torch.clamp(torch.amax(torch.linalg.vector_norm(
        torch.where(mask[:, None], xyz, 0.0) - torch.mean(xyz, dim=0), dim=-1)), min=_EPS)

    def seg(p, q):
        return torch.linalg.vector_norm(p - q, dim=-1) / (2 * scale)

    d_ab, d_bc, d_ca = seg(a, b), seg(b, c), seg(c, a)
    area = 0.5 * torch.linalg.vector_norm(_cross(b - a, c - a), dim=-1)
    d3 = torch.sqrt(torch.clamp(area, min=0.0)) / scale

    def angle(u, v):
        cu = torch.sum(u * v, dim=-1) / torch.clamp(
            torch.linalg.vector_norm(u, dim=-1) * torch.linalg.vector_norm(v, dim=-1), min=_EPS)
        return torch.arccos(torch.clamp(cu, -1.0, 1.0))

    a1, a2, a3 = angle(b - a, c - a), angle(a - b, c - b), angle(a - c, b - c)
    # in, out or mixed by the midpoints' distance to the cloud (the JAX
    # package's stand-in for PCL's voxel line tracing)
    mids = 0.5 * torch.cat([a + b, b + c, c + a], dim=0)
    _, md2 = bruteforce.nn1(xyz, mask, mids)
    inside = (md2 <= (0.05 * scale) ** 2).to(torch.float32).reshape(3, n_samples)
    ones = torch.ones(n_samples, dtype=torch.float32, device=xyz.device)

    def hist01(v, w=None):
        h = _hist(v, 0.0, 1.0, nbins, ones if w is None else w)
        return h / torch.clamp(torch.sum(h), min=_EPS)

    hists = [hist01(d_ab, inside[0]), hist01(d_ab, 1 - inside[0]), hist01(d_bc), hist01(d_ca),
             hist01(d3), hist01(a1 / math.pi), hist01(a2 / math.pi), hist01(a3 / math.pi),
             hist01((d_ab + d_bc + d_ca) / 3.0), hist01((d_ab - d_bc).abs())]
    return torch.cat(hists) * 100.0


def estimate_esf(cloud: Cloud, gen: Optional[torch.Generator] = None, n_samples: int = 4096,
                 nbins: int = 64) -> torch.Tensor:
    """ESF ``[10 nbins]`` from ``n_samples`` random triples drawn from
    ``gen``: ``draw_esf_samples``, then ``estimate_esf_core``."""
    return estimate_esf_core(cloud, draw_esf_samples(cloud.mask, n_samples, gen), nbins)
