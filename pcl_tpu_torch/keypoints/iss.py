"""ISS3D keypoints: intrinsic shape signatures.

Counterpart of ``pcl_tpu/keypoints/iss.py`` (PCL's ISSKeypoint3D). Per
point, the scatter matrix of its ``salient_radius`` neighbourhood (at most
``k`` nearest, brute radius search) and its eigenvalues ``l1 >= l2 >= l3``
(``eigh33``'s closed form); a point is a candidate where ``l2 / l1 <
gamma_21`` and ``l3 / l2 < gamma_32``, with saliency ``l3``; non-max
suppression over ``non_max_radius`` keeps every maximum, ties included.

By default the scatter matrix is PCL's plain unweighted sum of outer
products; ``density_weights=True`` weighs each neighbour by the inverse of
its neighbour count (the Zhong 2009 weighting) and normalizes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.search import bruteforce


def iss3d_keypoints(
    cloud: Cloud,
    salient_radius: float,
    non_max_radius: float,
    gamma_21: float = 0.975,
    gamma_32: float = 0.975,
    min_neighbors: int = 5,
    k: int = 64,
    density_weights: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(keypoint mask [N] bool, saliency [N] f32)``: the saliency is the
    smallest eigenvalue where the point is a candidate, 0 elsewhere."""
    xyz, mask = cloud.xyz, cloud.mask
    n = cloud.capacity
    idx, _, valid, count = bruteforce.radius(xyz, mask, xyz, salient_radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, n - 1)
    valid = valid & mask[:, None]
    if density_weights:
        wdens = 1.0 / torch.clamp(count.to(torch.float32), min=1.0)
        wj = wdens[idxc] * valid.to(torch.float32)                  # [N, k]
        wsum = torch.clamp(torch.sum(wj, dim=1), min=1e-12)
    else:
        wj = valid.to(torch.float32)
        wsum = torch.ones(n, dtype=torch.float32, device=xyz.device)
    d = xyz[idxc] - xyz[:, None, :]
    cov = torch.einsum("nk,nki,nkj->nij", wj, d, d) / wsum[:, None, None]
    lam, _ = geometry.eigh33(cov)                                   # ascending
    l3, l2, l1 = lam[:, 0], lam[:, 1], lam[:, 2]
    ok = (mask & (count >= min_neighbors)
          & (l2 / torch.clamp(l1, min=1e-12) < gamma_21)
          & (l3 / torch.clamp(l2, min=1e-12) < gamma_32)
          & (l3 > 0))
    saliency = torch.where(ok, l3, -torch.inf)
    # keep i where no neighbour within non_max_radius is strictly more
    # salient and that neighbourhood holds min_neighbors points
    nidx, _, nvalid, ncount = bruteforce.radius(xyz, mask, xyz, non_max_radius, cap=k)
    nbr_sal = torch.where(nvalid & mask[:, None],
                          saliency[torch.clamp(nidx.long(), 0, n - 1)], -torch.inf)
    is_max = ok & (ncount >= min_neighbors) & (saliency >= torch.amax(nbr_sal, dim=1))
    return is_max, torch.where(torch.isfinite(saliency), saliency, 0.0)
