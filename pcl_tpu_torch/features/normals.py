"""Surface normal estimation: batched neighbourhood covariance and the
analytic smallest eigenvector.

Counterpart of ``pcl_tpu/features/normals.py``: kNN gather ``[N, k, 3]`` ->
masked covariance -> ``eigh33`` -> flip towards the viewpoint -> curvature
``lambda_0 / (lambda_0 + lambda_1 + lambda_2)``. The neighbourhoods come from
the organized window search for organized self-queries, and otherwise from
the search dispatch: brute force on small clouds, the cell list above
``search._AUTO_PAIRS`` candidate pairs, with its cell size and bucket cap
probed on the host from the cloud's measured density unless given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch import search as search_mod
from pcl_tpu_torch.core import geometry
from pcl_tpu_torch.core.cloud import ATTR_CURVATURE, ATTR_NORMAL, Cloud
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.search import organized as org_mod


def normals_from_neighborhoods(
    pts: torch.Tensor,          # [N, 3] query points
    nbr: torch.Tensor,          # [N, k, 3] gathered neighbour coordinates
    nbr_valid: torch.Tensor,    # [N, k] bool
    viewpoint: torch.Tensor,    # [3]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plane fit per point: ``(normals [N, 3], curvature [N])``, the normal
    flipped towards the viewpoint; both 0 where fewer than 3 neighbours are
    valid (PCL's NaN normal)."""
    _, cov, cnt = geometry.mean_and_covariance(nbr, nbr_valid)
    lam, V = geometry.eigh33(cov)
    n = V[..., :, 0]
    flip = torch.sum(n * (viewpoint[None, :] - pts), dim=-1) < 0.0
    n = torch.where(flip[:, None], -n, n)
    lam_sum = torch.sum(lam, dim=-1)
    curvature = torch.where(lam_sum > 0, lam[..., 0] / torch.clamp(lam_sum, min=1e-12), 0.0)
    ok = cnt >= 3.0
    return torch.where(ok[:, None], n, 0.0), torch.where(ok, curvature, 0.0)


def _is_organized(cloud: Cloud, surface: Optional[Cloud]) -> bool:
    return (surface is None and cloud.height > 1 and cloud.width > 1
            and cloud.width * cloud.height == cloud.capacity)


def _estimate_normals(
    cloud: Cloud,
    k: int,
    viewpoint: Optional[torch.Tensor],
    surface: Optional[Cloud],
    backend: str,
    cell_size: Optional[float],
    radius: Optional[float],
    cell_cap: int,
) -> Cloud:
    dev = cloud.xyz.device
    viewpoint = torch.zeros(3, device=dev) if viewpoint is None \
        else torch.as_tensor(viewpoint, dtype=torch.float32, device=dev)
    surf = surface if surface is not None else cloud
    organized = _is_organized(cloud, surface)
    if backend == "organized" or (backend == "auto" and organized):
        if not organized:
            raise ValueError("backend='organized' requires an organized "
                             "self-query cloud")
        H, W = cloud.height, cloud.width
        idx, d2, valid = org_mod.self_knn(cloud.xyz.reshape(H, W, 3),
                                          cloud.mask.reshape(H, W), k,
                                          window=9 if k <= 24 else 13)
    elif backend == "bruteforce":
        idx, d2, valid = bruteforce.knn(surf.xyz, surf.mask, cloud.xyz, k)
    else:
        idx, d2, valid = search_mod.knn(surf, cloud.xyz, k, backend=backend,
                                        cell_size=cell_size, cell_cap=cell_cap)
    nbr = surf.xyz[torch.clamp(idx.long(), 0, surf.capacity - 1)]
    nbr_valid = valid & cloud.mask[:, None]
    if radius is not None:
        nbr_valid = nbr_valid & (d2 <= float(np.float32(radius) ** 2))
    n, c = normals_from_neighborhoods(cloud.xyz, nbr, nbr_valid, viewpoint)
    n = torch.where(cloud.mask[:, None], n, 0.0)
    c = torch.where(cloud.mask, c, 0.0)
    return cloud.with_attrs(**{ATTR_NORMAL: n, ATTR_CURVATURE: c})


def estimate_normals(
    cloud: Cloud,
    k: int = 16,
    viewpoint: Optional[torch.Tensor] = None,
    surface: Optional[Cloud] = None,
    backend: str = "auto",
    cell_size: Optional[float] = None,
    radius: Optional[float] = None,
    cell_cap: Optional[int] = None,
) -> Cloud:
    """Attach ``normal`` and ``curvature`` computed from k-NN neighbourhoods.

    ``viewpoint`` (default the origin) orients the normals; ``surface`` is
    the search cloud when it differs from the query cloud; ``radius`` gates
    the k neighbours to a ball. When the cell list will carry the search
    (``backend="cell"``, or ``"auto"`` on a large unorganized cloud) and
    ``cell_cap`` is not given, the cap, and the cell size unless given, come
    from the host density probe ``search.auto_cell_params``."""
    if cell_cap is None:
        surf = surface if surface is not None else cloud
        engages_cell = backend == "cell" or (
            backend == "auto" and not _is_organized(cloud, surface)
            and surf.capacity * cloud.capacity > search_mod._AUTO_PAIRS)
        if engages_cell:
            probed_size, cell_cap = search_mod.auto_cell_params(surf, k, cell_size)
            if cell_size is None:
                cell_size = probed_size
    return _estimate_normals(cloud, k, viewpoint, surface, backend, cell_size,
                             radius, 24 if cell_cap is None else cell_cap)


def flip_normals_towards_viewpoint(cloud: Cloud, viewpoint: torch.Tensor) -> Cloud:
    """Re-orient existing normals towards a viewpoint."""
    n = cloud.attrs[ATTR_NORMAL]
    vp = torch.as_tensor(viewpoint, dtype=torch.float32, device=n.device)
    flip = torch.sum(n * (vp[None, :] - cloud.xyz), dim=-1) < 0.0
    return cloud.with_attrs(**{ATTR_NORMAL: torch.where(flip[:, None], -n, n)})
