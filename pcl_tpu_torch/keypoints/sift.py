"""SIFT keypoints on point clouds: difference-of-Gaussian extrema per octave.

Counterpart of ``pcl_tpu/keypoints/sift.py`` (PCL's SIFTKeypoint):

- each octave voxel-downsamples the previous octave's cloud at the octave's
  base scale (kernel B2 on the card), stopping below 25 points; the octave
  loop runs on the host, which reads each octave's voxel count back and
  slices the cloud to ``max(count, 32)`` rows;
- an octave evaluates S + 3 Gaussian responses (sigma_i = base 2^((i - 1) /
  S)) over one radius neighbourhood of 3 sigma_max with PCL's 9 sigma^2 cut,
  giving S + 2 difference-of-Gaussian scales;
- a point is a keypoint at an interior scale where its value is the minimum
  (maximum) of its 25-NN neighbourhood there and strictly below (above) the
  neighbourhood's at the scales beside it, and at least ``min_contrast``.

``sift_keypoints_cloud`` returns the octave clouds' points as a cloud with a
``scale`` attribute, octave then point order; ``sift_keypoints`` snaps each
to its nearest input point (``bruteforce.nn1``, kernel B1 on the card) and
keeps the larger scale where two snap to one point.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_CURVATURE, ATTR_INTENSITY, Cloud
from pcl_tpu_torch.filters.voxel_grid import voxel_downsample
from pcl_tpu_torch.search import bruteforce


def _octave_extrema(xyz, mask, field, base_scale: float, scales_per_octave: int,
                    min_contrast: float, cap: int, k_extrema: int):
    """One octave: ``(extremum [N, S + 2] bool, sigma [S + 2])``."""
    S = scales_per_octave
    n = xyz.shape[0]
    base = np.float32(base_scale)
    sigmas = np.array([2.0 ** ((i - 1.0) / S) for i in range(S + 3)], np.float32) * base
    r_max = float(np.float32(3.0) * sigmas[-1])
    idx, d2, valid, _ = bruteforce.radius(xyz, mask, xyz, r_max, cap=cap)
    idxc = torch.clamp(idx.long(), 0, n - 1)
    valid = valid & mask[:, None]
    fv = field[idxc]

    def response(sig):
        sig2 = float(sig * sig)
        w = torch.where(valid & (d2 <= float(np.float32(9.0) * np.float32(sig2))),
                        torch.exp(-0.5 * d2 / sig2), 0.0)
        return torch.sum(w * fv, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1e-12)

    resp = torch.stack([response(s) for s in sigmas], dim=1)      # [N, S + 3]
    dog = resp[:, 1:] - resp[:, :-1]                              # [N, S + 2]
    kidx, _, kvalid = bruteforce.knn(xyz, mask, xyz, k_extrema)
    kvalid = (kvalid & mask[:, None])[:, :, None]
    nbr = dog[torch.clamp(kidx.long(), 0, n - 1)]
    nmin = torch.amin(torch.where(kvalid, nbr, torch.inf), dim=1)
    nmax = torch.amax(torch.where(kvalid, nbr, -torch.inf), dim=1)
    inf = torch.full((n, 1), torch.inf, device=xyz.device)
    prev_min, next_min = torch.cat([inf, nmin[:, :-1]], 1), torch.cat([nmin[:, 1:], inf], 1)
    prev_max, next_max = torch.cat([-inf, nmax[:, :-1]], 1), torch.cat([nmax[:, 1:], -inf], 1)
    cols = torch.arange(S + 2, device=xyz.device)
    interior = (cols >= 1) & (cols <= S)
    is_min = (dog == nmin) & (dog < prev_min) & (dog < next_min)
    is_max = (dog == nmax) & (dog > prev_max) & (dog > next_max)
    ext = ((dog.abs() >= float(np.float32(min_contrast))) & (is_min | is_max)
           & interior[None, :] & mask[:, None])
    return ext, sigmas[:S + 2]


def _field_of(cloud: Cloud, field_attr: Optional[str]) -> torch.Tensor:
    if field_attr is not None:
        return cloud.attrs[field_attr]
    if ATTR_INTENSITY in cloud.attrs:
        return cloud.attrs[ATTR_INTENSITY]
    if ATTR_CURVATURE in cloud.attrs:
        return cloud.attrs[ATTR_CURVATURE]
    return cloud.xyz[:, 2]


def sift_keypoints_cloud(
    cloud: Cloud,
    min_scale: float,
    n_octaves: int = 3,
    scales_per_octave: int = 3,
    min_contrast: float = 1e-3,
    field_attr: Optional[str] = None,
    cap: int = 512,
    k_extrema: int = 25,
) -> Cloud:
    """PCL's SIFT: a cloud of keypoints (points of the octave clouds) with a
    ``scale`` attribute, in octave-then-point order; capacity the keypoint
    count (at least 1)."""
    dev = cloud.xyz.device
    work = cloud
    scale = float(min_scale)
    out_xyz, out_scale = [], []
    for _ in range(n_octaves):
        ds = voxel_downsample(work, scale)
        n_pts = int(torch.sum(ds.mask))
        if n_pts < 25:
            break
        pad = max(n_pts, 32)
        work = Cloud(xyz=ds.xyz[:pad], mask=ds.mask[:pad],
                     attrs={k: v[:pad] for k, v in ds.attrs.items()})
        field = _field_of(work, field_attr).to(torch.float32)
        ext, sigmas = _octave_extrema(work.xyz, work.mask, field, scale, scales_per_octave,
                                      min_contrast, min(cap, pad), min(k_extrema, pad))
        pts, sc = torch.nonzero(ext, as_tuple=True)               # row-major, as np.nonzero
        out_xyz.append(work.xyz[pts])
        out_scale.append(torch.from_numpy(sigmas).to(dev)[sc])
        scale *= 2.0
    kx = torch.cat(out_xyz) if out_xyz else torch.zeros((0, 3), device=dev)
    ks = torch.cat(out_scale) if out_scale else torch.zeros(0, device=dev)
    m = kx.shape[0]
    cap_out = max(m, 1)
    xyz = torch.zeros((cap_out, 3), dtype=torch.float32, device=dev)
    xyz[:m] = kx
    sc_arr = torch.zeros(cap_out, dtype=torch.float32, device=dev)
    sc_arr[:m] = ks
    mask = torch.arange(cap_out, device=dev) < m
    return Cloud(xyz=xyz, mask=mask, attrs={"scale": sc_arr})


def sift_keypoints(
    cloud: Cloud,
    min_scale: float,
    n_octaves: int = 3,
    scales_per_octave: int = 3,
    min_contrast: float = 1e-3,
    field: Optional[torch.Tensor] = None,
    k: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mask API: ``(keypoint mask [N], scale [N])`` over the input
    points, each keypoint snapped to its nearest input point. ``field``
    overrides the filtered attribute (intensity, else curvature, else z)."""
    if field is not None:
        work = Cloud(xyz=cloud.xyz, mask=cloud.mask,
                     attrs=dict(cloud.attrs, sift_field=field),
                     width=cloud.width, height=cloud.height)
        kp = sift_keypoints_cloud(work, min_scale, n_octaves, scales_per_octave, min_contrast,
                                  field_attr="sift_field")
    else:
        kp = sift_keypoints_cloud(cloud, min_scale, n_octaves, scales_per_octave, min_contrast)
    n = cloud.capacity
    dev = cloud.xyz.device
    mask_out = torch.zeros(n, dtype=torch.bool, device=dev)
    scale_out = torch.zeros(n, dtype=torch.float32, device=dev)
    live = torch.nonzero(kp.mask)[:, 0]
    if live.numel() == 0:
        return mask_out, scale_out
    idx, _ = bruteforce.nn1(cloud.xyz, cloud.mask, kp.xyz)
    idx = idx.long()[live]
    mask_out[idx] = True
    # the larger scale where two keypoints snap to one input point
    scale_out.scatter_reduce_(0, idx, kp.attrs["scale"][live], reduce="amax")
    return mask_out, scale_out
