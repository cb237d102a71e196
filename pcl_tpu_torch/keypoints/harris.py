"""Harris 3-D keypoints: the corner response of the normals' covariance.

Counterpart of ``pcl_tpu/keypoints/harris.py`` (PCL's HarrisKeypoint3D):
the covariance of the normals over ``radius`` (at most ``k`` nearest), one
of PCL's responses (Harris, Noble, Lowe, Tomasi, or the curvature itself),
and non-maximum suppression over the same radius, the lowest index winning
a tie.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import ATTR_CURVATURE, ATTR_NORMAL, Cloud
from pcl_tpu_torch.features.shot import _f32
from pcl_tpu_torch.search import bruteforce

RESPONSES = ("harris", "noble", "lowe", "tomasi", "curvature")


def _non_max(resp, idxc, valid, mask):
    """Per point the neighbourhood's largest response and the lowest index
    that holds it."""
    n = resp.shape[0]
    nbr_resp = torch.where(valid & mask[:, None], resp[idxc], -torch.inf)
    neigh_max = torch.amax(nbr_resp, dim=1)
    first = torch.amin(torch.where(nbr_resp >= neigh_max[:, None], idxc, n), dim=1)
    return neigh_max, first == torch.arange(n, device=resp.device)


def harris3d_keypoints(
    cloud: Cloud,
    radius: float,
    threshold: float = 0.0,
    response: str = "harris",
    harris_k: float = 0.04,
    k: int = 48,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(keypoint mask [N], response [N])``; requires normals (and
    curvature for ``response="curvature"``)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("harris3d requires normals")
    xyz, mask = cloud.xyz, cloud.mask
    normals = cloud.attrs[ATTR_NORMAL]
    n = cloud.capacity
    idx, _, valid, _ = bruteforce.radius(xyz, mask, xyz, radius, cap=k)
    idxc = torch.clamp(idx.long(), 0, n - 1)
    if response == "curvature":
        resp = cloud.attrs.get(ATTR_CURVATURE)
        if resp is None:
            raise ValueError("response='curvature' requires a curvature attr")
    else:
        w = (valid & mask[:, None]).to(torch.float32)
        nn = normals[idxc]
        wsum = torch.clamp(torch.sum(w, dim=1), min=1.0)
        C = torch.einsum("nk,nki,nkj->nij", w, nn, nn) / wsum[:, None, None]
        if response == "harris":
            # PCL: 0.04 + det - 0.04 trace^2, so that a flat patch scores ~0
            tr = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1)
            hk = _f32(harris_k)
            resp = hk + torch.linalg.det(C) - hk * tr * tr
        elif response == "noble":
            tr = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1)
            resp = torch.linalg.det(C) / torch.clamp(tr, min=1e-12)
        elif response == "lowe":
            lam, _ = geometry.eigh33(C)
            resp = lam[:, 2] * lam[:, 1] / torch.clamp(lam[:, 2] + lam[:, 1], min=1e-12)
        elif response == "tomasi":
            resp = geometry.eigh33(C)[0][:, 0]
        else:
            raise ValueError(f"unknown response {response!r}")
    resp = torch.where(mask, resp, -torch.inf)
    neigh_max, first = _non_max(resp, idxc, valid, mask)
    is_max = mask & (resp > threshold) & (resp >= neigh_max) & first
    return is_max, torch.where(torch.isfinite(resp), resp, 0.0)
