"""Organized (image-grid) segmentation: connected components by comparator,
multi-plane extraction, polygonal prisms.

Counterpart of ``pcl_tpu/segmentation/organized.py``.

- ``organized_connected_components`` (PCL's
  OrganizedConnectedComponentSegmentation with the EuclideanComparator):
  4-neighbour comparator tests as shifted-image ops, then labels by
  ``propagate_min_labels``.
- ``organized_multi_plane_segmentation`` (PCL's
  OrganizedMultiPlaneSegmentation): neighbours connect when their normals
  agree within ``angular_threshold`` and their plane offsets within
  ``distance_threshold``; each component with at least ``min_inliers``
  pixels gets a plane refitted on the host, as in the JAX package.
- ``extract_polygonal_prism`` (PCL's ExtractPolygonalPrismData): the points
  between two heights above a plane whose projection lies inside a hull
  polygon (ray-crossing parity over the hull's edges).

``propagate_min_labels`` gives each pixel the smallest flat index of its
component, the fixed point of the JAX package's min-label flood, which has
no sweep cap. It adds pointer jumping (a pixel takes its label's label) and
reads the change flag back once every 8 sweeps (ROADMAP C59).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud, _device
from pcl_tpu_torch.features.shot import _f32

_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))     # from above, below, the left, the right
_CHECK_EVERY = 8                                # sweeps between read-backs of the change flag


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=_device(device))


def _cut(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Set the row or column that a roll by ``(dy, dx)`` wrapped around to
    ``fill``."""
    a = a.clone()
    if dy == 1:
        a[0, :] = fill
    if dy == -1:
        a[-1, :] = fill
    if dx == 1:
        a[:, 0] = fill
    if dx == -1:
        a[:, -1] = fill
    return a


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``a`` moved by ``(dy, dx)`` pixels, the wrapped row or column ``fill``."""
    return _cut(torch.roll(a, (dy, dx), (0, 1)), dy, dx, fill)


def propagate_min_labels(adj_ok: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``adj_ok [H, W, 4]``: each pixel's link to the pixel above, below,
    left and right of it (a symmetric relation). Returns ``[H, W]`` int64
    labels, each pixel's smallest flat index in its component, -1 where
    invalid."""
    H, W = valid.shape
    big = H * W
    flat = torch.arange(big, device=valid.device).reshape(H, W)
    lab = torch.where(valid, flat, big)
    while True:
        before = lab
        for _ in range(_CHECK_EVERY):
            cand = lab
            for i, (dy, dx) in enumerate(_DIRS):
                cand = torch.minimum(cand, torch.where(adj_ok[..., i], _shift(lab, dy, dx, big),
                                                       big))
            # pointer jumping: a label is a pixel of the same component
            rep = cand.reshape(-1)[torch.clamp(cand, 0, big - 1).reshape(-1)].reshape(H, W)
            lab = torch.where(valid, torch.minimum(cand, rep), big)
        if not bool(torch.any(lab != before)):
            break
    return torch.where(valid, lab, -1)


def _neighbour_links(valid: torch.Tensor, ok_with) -> torch.Tensor:
    """``[H, W, 4]`` links: ``ok_with(dy, dx)`` against the pixel that a
    roll by ``(dy, dx)`` brings here, both valid, never across the image's
    edge."""
    return torch.stack([_cut(ok_with(dy, dx) & torch.roll(valid, (dy, dx), (0, 1)) & valid,
                             dy, dx, False) for dy, dx in _DIRS], dim=-1)


def organized_connected_components(xyz_img, valid, distance_threshold: float = 0.02,
                                   max_sweeps: int = 256, device=None) -> torch.Tensor:
    """``[H, W]`` labels (-1 invalid): 4-neighbours connect when closer than
    ``distance_threshold`` (EuclideanComparator). ``max_sweeps`` is kept for
    the JAX signature; neither package caps the flood."""
    xyz_img = _as_tensor(xyz_img, device, torch.float32)
    valid = _as_tensor(valid, xyz_img.device, torch.bool)
    d2 = _f32(np.float32(distance_threshold) * np.float32(distance_threshold))

    def ok_with(dy, dx):
        nb = torch.roll(xyz_img, (dy, dx), (0, 1))
        return torch.sum((xyz_img - nb) ** 2, dim=-1) < d2

    return propagate_min_labels(_neighbour_links(valid, ok_with), valid)


class PlanarRegion(NamedTuple):
    coefficients: np.ndarray  # [4] (nx, ny, nz, d)
    centroid: np.ndarray      # [3]
    indices: np.ndarray       # flat pixel indices
    count: int


def plane_adjacency(xyz_img: torch.Tensor, normals_img: torch.Tensor, valid: torch.Tensor,
                    angular_threshold: float, distance_threshold: float) -> torch.Tensor:
    """``[H, W, 4]`` links of the PlaneCoefficientComparator: normals within
    ``angular_threshold`` and plane offsets ``-n.p`` within
    ``distance_threshold``."""
    d_plane = -torch.sum(xyz_img * normals_img, dim=-1)
    cos_thr = torch.cos(torch.tensor(_f32(angular_threshold), device=xyz_img.device))

    def ok_with(dy, dx):
        nbn = torch.roll(normals_img, (dy, dx), (0, 1))
        nbd = torch.roll(d_plane, (dy, dx), (0, 1))
        return ((torch.sum(normals_img * nbn, dim=-1) > cos_thr)
                & (torch.abs(d_plane - nbd) < _f32(distance_threshold)))

    return _neighbour_links(valid, ok_with)


def organized_multi_plane_segmentation(xyz_img, normals_img, valid, min_inliers: int = 100,
                                       angular_threshold: float = 0.052,
                                       distance_threshold: float = 0.02, device=None
                                       ) -> Tuple[np.ndarray, list]:
    """Planar regions of an organized frame: ``([H, W] int32 labels, list of
    PlanarRegion)``, regions of at least ``min_inliers`` pixels numbered in
    the order of their smallest pixel, their planes refitted on the host
    (covariance, smallest eigenvector, turned towards the origin)."""
    xyz_t = _as_tensor(xyz_img, device, torch.float32)
    n_t = _as_tensor(normals_img, xyz_t.device, torch.float32)
    v_t = _as_tensor(valid, xyz_t.device, torch.bool)
    adj = plane_adjacency(xyz_t, n_t, v_t, angular_threshold, distance_threshold)
    labels = propagate_min_labels(adj, v_t).cpu().numpy()

    flat = labels.reshape(-1)
    xyz_f = xyz_t.cpu().numpy().reshape(-1, 3)
    ids, counts = np.unique(flat[flat >= 0], return_counts=True)
    regions = []
    out_labels = np.full(labels.shape, -1, np.int32)
    for lab in ids[counts >= min_inliers]:
        ii = np.flatnonzero(flat == lab)
        pts = xyz_f[ii]
        c = pts.mean(0)
        _, v = np.linalg.eigh(np.cov((pts - c).T))
        nrm = v[:, 0]
        if nrm[2] > 0:                                       # towards a viewpoint at the origin
            nrm = -nrm
        coeff = np.concatenate([nrm, [-float(nrm @ c)]]).astype(np.float32)
        out_labels.reshape(-1)[ii] = len(regions)
        regions.append(PlanarRegion(coeff, c.astype(np.float32), ii, len(ii)))
    return out_labels, regions


def prism_mask(xyz: torch.Tensor, mask: torch.Tensor, coeff: torch.Tensor, hull_pts2: torch.Tensor,
               u: torch.Tensor, v: torch.Tensor, origin: torch.Tensor, height_min: float,
               height_max: float) -> torch.Tensor:
    """Points between the heights above the plane whose in-plane projection
    lies inside the hull polygon ``[P, 2]`` (ray-crossing parity)."""
    dist = xyz @ coeff[:3] + coeff[3]
    in_band = (dist >= _f32(height_min)) & (dist <= _f32(height_max)) & mask
    rel = xyz - origin[None, :]
    px, py = (rel @ u)[:, None], (rel @ v)[:, None]
    x1, y1 = hull_pts2[:, 0][None], hull_pts2[:, 1][None]
    b = torch.roll(hull_pts2, -1, dims=0)
    x2, y2 = b[:, 0][None], b[:, 1][None]
    crosses = ((y1 > py) != (y2 > py)) & (px < (x2 - x1) * (py - y1) / (y2 - y1 + 1e-30) + x1)
    return in_band & ((torch.sum(crosses.to(torch.int32), dim=1) % 2) == 1)


def extract_polygonal_prism(cloud: Cloud, hull_points: np.ndarray,
                            plane_coefficients: np.ndarray, height_min: float = 0.0,
                            height_max: float = 0.5) -> np.ndarray:
    """``[N]`` bool mask of the points inside the prism swept from the hull
    polygon along the plane's normal (setHeightLimits)."""
    coeff = np.asarray(plane_coefficients, np.float32)
    n = coeff[:3] / (np.linalg.norm(coeff[:3]) + 1e-12)
    coeff = np.concatenate([n, [coeff[3] / (np.linalg.norm(plane_coefficients[:3]) + 1e-12)]])
    a = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(a, n)
    u /= np.linalg.norm(u) + 1e-12
    v = np.cross(n, u)
    hull = np.asarray(hull_points, np.float32)
    origin = hull.mean(0)
    h2 = np.stack([(hull - origin) @ u, (hull - origin) @ v], 1).astype(np.float32)
    dev = cloud.xyz.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return prism_mask(cloud.xyz, cloud.mask, t(coeff), t(h2), t(u), t(v), t(origin), height_min,
                      height_max).cpu().numpy()
