"""More filters: frustum culling, projection onto and removal by a model,
grid minimum, local maximum, shadow points, the intensity bilateral filter,
normal refinement, the approximate voxel grid and index extraction.

Counterpart of ``pcl_tpu/filters/extras.py`` (PCL's FrustumCulling,
ProjectInliers, ModelOutlierRemoval, GridMinimum, LocalMaximum, ShadowPoints,
BilateralFilter, NormalRefinement, ApproximateVoxelGrid, ExtractIndices).
The hashes of ``grid_minimum`` and ``approximate_voxel_grid`` wrap in int32 as
the JAX package's do (``cell_list._mul32``). ``approximate_voxel_grid``'s
per-bucket sums are plain XLA there and are torch ops here: ``index_put_``
with accumulation, which adds in point order on both devices, not kernel B2.
"""

from __future__ import annotations

import math

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_INTENSITY, ATTR_NORMAL, Cloud
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.sac.models import SacModel
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.search.cell_list import _mul32


def frustum_culling(cloud: Cloud, camera_pose: torch.Tensor, h_fov: float = math.pi / 3,
                    v_fov: float = math.pi / 4, near: float = 0.0, far: float = math.inf,
                    negative: bool = False) -> Cloud:
    """Keep the points inside the camera's view frustum; the camera looks
    along +x with +z up (PCL's convention)."""
    w2c = torch.linalg.inv(camera_pose.to(cloud.xyz.device, torch.float32))
    p = cloud.xyz @ w2c[:3, :3].T + w2c[:3, 3]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    keep = ((x >= near) & (x <= far) & (torch.abs(torch.atan2(y, x)) <= h_fov / 2)
            & (torch.abs(torch.atan2(z, x)) <= v_fov / 2))
    return cloud.with_mask(keep ^ negative)


def project_inliers(cloud: Cloud, model: SacModel, coefficients: torch.Tensor) -> Cloud:
    """Every point projected onto the model's surface."""
    proj = model.project(coefficients[None], cloud.xyz).reshape(cloud.xyz.shape)
    return cloud.with_xyz(torch.where(cloud.mask[:, None], proj, 0.0))


def model_outlier_removal(cloud: Cloud, model: SacModel, coefficients: torch.Tensor,
                          threshold: float, negative: bool = False) -> Cloud:
    """Keep the points within ``threshold`` of the model."""
    keep = model.distances(coefficients[None], cloud.xyz).reshape(-1) <= threshold
    return cloud.with_mask(keep ^ negative)


def _hash_cells(cell: torch.Tensor, primes, table: int) -> torch.Tensor:
    """``|xor of cell_a * prime_a| % table`` with int32 wrapping products."""
    u = cell.to(torch.int64) & 0xFFFFFFFF
    h = _mul32(u[:, 0], primes[0])
    for a in range(1, len(primes)):
        h = h ^ _mul32(u[:, a], primes[a])
    h = torch.where(h >= 2 ** 31, h - 2 ** 32, h)       # the int32 value
    # abs(INT_MIN) wraps to INT_MIN in int32; both are 0 modulo a power of two
    return torch.abs(h) % table


def grid_minimum(cloud: Cloud, resolution: float) -> Cloud:
    """Keep the lowest (least z) point of each 2-D grid cell, the first in
    index order on a tie (GridMinimum, a DEM for ground filtering)."""
    n, table = cloud.capacity, 1 << 20
    cell = xla_int32(torch.floor(cloud.xyz[:, :2] / resolution))
    h = torch.where(cloud.mask, _hash_cells(cell, (73856093, 19349669), table), table)
    z = torch.where(cloud.mask, cloud.xyz[:, 2], math.inf)
    zmin = torch.full((table + 1,), math.inf, dtype=torch.float32,
                      device=z.device).scatter_reduce(0, h, z, "amin")
    pos = torch.arange(n, device=z.device)
    is_min = cloud.mask & (z == zmin[h])
    first = torch.full((table + 1,), n, dtype=torch.int64, device=z.device).scatter_reduce(
        0, h, torch.where(is_min, pos, n), "amin")
    return cloud.with_mask(is_min & (pos == first[h]))


def local_maximum(cloud: Cloud, radius: float, cap: int = 32) -> Cloud:
    """Keep the points that are the z maximum among their (up to ``cap``
    nearest) neighbours within ``radius`` in x and y (LocalMaximum)."""
    xy = torch.cat([cloud.xyz[:, :2], torch.zeros_like(cloud.xyz[:, :1])], dim=1)
    idx, _d2, valid, _ = bruteforce.radius(xy, cloud.mask, xy, radius, cap)
    z = cloud.xyz[:, 2]
    nz = torch.where(valid & cloud.mask[:, None],
                     z[torch.clamp(idx.long(), 0, cloud.capacity - 1)], -math.inf)
    return cloud.with_mask(z >= torch.amax(nz, dim=1))


def shadow_points(cloud: Cloud, threshold: float = 0.1) -> Cloud:
    """Remove veil points: those whose normal is nearly perpendicular to the
    viewing ray from the origin (ShadowPoints)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("shadow_points requires normals")
    ray = cloud.xyz / torch.clamp(torch.linalg.vector_norm(cloud.xyz, dim=-1, keepdim=True),
                                  min=1e-12)
    val = torch.abs(torch.sum(cloud.attrs[ATTR_NORMAL] * ray, dim=-1))
    return cloud.with_mask(val >= threshold)


def bilateral_filter(cloud: Cloud, sigma_s: float = 0.05, sigma_r: float = 0.05,
                     cap: int = 32) -> Cloud:
    """Edge-preserving smoothing of the ``intensity`` attribute over the (up
    to ``cap`` nearest) neighbours within ``2 sigma_s`` (BilateralFilter)."""
    if ATTR_INTENSITY not in cloud.attrs:
        raise ValueError("bilateral_filter requires an intensity attr")
    inten = cloud.attrs[ATTR_INTENSITY]
    idx, d2, valid, _ = bruteforce.radius(cloud.xyz, cloud.mask, cloud.xyz, 2.0 * sigma_s, cap)
    ni = inten[torch.clamp(idx.long(), 0, cloud.capacity - 1)]
    dv = ni - inten[:, None]
    w = torch.exp(-d2 / (2 * sigma_s ** 2) - dv ** 2 / (2 * sigma_r ** 2))
    w = torch.where(valid & cloud.mask[:, None], w, 0.0)
    out = torch.sum(w * ni, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1e-12)
    return cloud.with_attrs(**{ATTR_INTENSITY: torch.where(cloud.mask, out, 0.0)})


def normal_refinement(cloud: Cloud, k: int = 8, iterations: int = 3) -> Cloud:
    """``iterations`` rounds of averaging each normal over its ``k`` nearest
    neighbours, keeping its orientation (NormalRefinement)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("normal_refinement requires normals")
    idx, _d2, valid = bruteforce.knn(cloud.xyz, cloud.mask, cloud.xyz, k)
    idxc = torch.clamp(idx.long(), 0, cloud.capacity - 1)
    w = (valid & cloud.mask[:, None]).to(torch.float32)
    n = cloud.attrs[ATTR_NORMAL]
    for _ in range(iterations):
        avg = torch.einsum("nk,nki->ni", w, n[idxc])
        avg = avg / torch.clamp(torch.linalg.vector_norm(avg, dim=-1, keepdim=True), min=1e-12)
        n = torch.where((torch.sum(avg * n, dim=-1) < 0)[:, None], -avg, avg)
    return cloud.with_attrs(**{ATTR_NORMAL: torch.where(cloud.mask[:, None], n, 0.0)})


def approximate_voxel_grid(cloud: Cloud, leaf_size) -> Cloud:
    """Centroids of a 2^16-bucket voxel hash in one pass: colliding voxels
    merge, as in the reference's fixed-size hash (ApproximateVoxelGrid). The
    occupied buckets come first, in bucket order; the capacity is the
    smaller of the cloud's and the table's."""
    table = 1 << 16
    dev = cloud.xyz.device
    leaf = torch.as_tensor(leaf_size, dtype=torch.float32).to(dev).expand(3)
    cell = xla_int32(torch.floor(cloud.xyz / leaf))
    h = torch.where(cloud.mask, _hash_cells(cell, (73856093, 19349669, 83492791), table), table)
    w = cloud.mask.to(torch.float32)
    sums = torch.zeros((table + 1, 4), dtype=torch.float32, device=dev)
    add_rows(sums, h, torch.cat([cloud.xyz * w[:, None], w[:, None]], dim=1))
    cent = sums[:table, :3] / torch.clamp(sums[:table, 3], min=1.0)[:, None]
    occupied = sums[:table, 3] > 0
    order = torch.argsort((~occupied).to(torch.int32), stable=True)[:cloud.capacity]
    m = occupied[order]
    return Cloud(xyz=torch.where(m[:, None], cent[order], 0.0), mask=m, attrs={},
                 width=0, height=1)


def extract_indices(cloud: Cloud, indices, negative: bool = False) -> Cloud:
    """Keep (or, with ``negative``, drop) an explicit set of indices
    (ExtractIndices)."""
    sel = torch.zeros(cloud.capacity, dtype=torch.bool, device=cloud.xyz.device)
    sel[torch.as_tensor(indices, dtype=torch.int64).to(sel.device)] = True
    return cloud.with_mask(sel ^ negative)
