"""Organized edge detection — occluding / occluded / NaN-boundary /
high-curvature / RGB edges on organized clouds.

Re-design of pcl::OrganizedEdgeBase / OrganizedEdgeFromRGB /
OrganizedEdgeFromNormals / OrganizedEdgeFromRGBNormals (reference:
features/include/pcl/features/organized_edge_detection.h + impl,
organized_edge_detection.hpp:83-220): per interior pixel, the depth
differences to the 8 neighbors classify depth discontinuities — the
dominant (largest-magnitude) difference beyond ``th * |z|`` marks the
pixel OCCLUDED when positive (a farther surface behind an occluder) or
OCCLUDING when negative; pixels with invalid neighbors march across the
NaN region along the mean invalid direction to find a corresponding
finite depth (same classification), or become NAN_BOUNDARY when none is
found within ``max_search_neighbors`` steps. RGB edges are Canny over
the mean-channel gray image (hpp:240-270); high-curvature edges are
Canny run on the (n_x, n_y) normal components as gradient images
(hpp:283-330).

Counterpart of ``pcl_tpu/features/organized_edge.py``: the 8-neighbour
pass is 8 rolled images, the NaN march a loop of ``max_search_neighbors -
1`` gathers over the whole image (the JAX module's ``lax.scan``), Canny the
port's ``image.ops``. The march's mean direction is the sum of the invalid
directions (small integers, exact) over their count; the grey image is the
channels' sum times the float32 reciprocal of 3, as XLA forms ``jnp.mean``
(ROADMAP C79, C91).
"""

from __future__ import annotations

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import Cloud, ATTR_NORMAL, ATTR_RGB
from pcl_tpu_torch.image import ops as img_ops

EDGELABEL_NAN_BOUNDARY = 1
EDGELABEL_OCCLUDING = 2
EDGELABEL_OCCLUDED = 4
EDGELABEL_HIGH_CURVATURE = 8
EDGELABEL_RGB_CANNY = 16

# the reference's 8-neighborhood order (organized_edge_detection.hpp:88):
# (d_col, d_row)
_DIRS = ((-1, 0), (-1, -1), (0, -1), (1, -1),
         (1, 0), (1, 1), (0, 1), (-1, 1))
_THIRD = float(np.float32(1.0) / np.float32(3.0))


def _shift(img, d_col, d_row, fill):
    """img[r + d_row, c + d_col] with out-of-range reads returning fill."""
    out = torch.roll(img, (-d_row, -d_col), (0, 1))
    h, w = img.shape
    rows = torch.arange(h, device=img.device)[:, None] + d_row
    cols = torch.arange(w, device=img.device)[None, :] + d_col
    inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return torch.where(inb, out, torch.tensor(fill, dtype=img.dtype, device=img.device))


def march_steps(inv: torch.Tensor):
    """``(dx, dy)`` of the NaN march: the mean of the invalid neighbours'
    directions, ``inv`` ``[8, H, W]`` in ``_DIRS`` order."""
    n_inv = torch.clamp(inv.sum(0).to(torch.float32), min=1.0)
    f = inv.to(torch.float32)
    dx = sum(float(d[0]) * f[i] for i, d in enumerate(_DIRS)) / n_inv
    dy = sum(float(d[1]) * f[i] for i, d in enumerate(_DIRS)) / n_inv
    return dx, dy


def organized_edge_detection(
    cloud: Cloud,
    depth_discon_threshold: float = 0.02,
    max_search_neighbors: int = 50,
    edge_types: int = (EDGELABEL_NAN_BOUNDARY | EDGELABEL_OCCLUDING
                       | EDGELABEL_OCCLUDED),
    hc_canny_low: float = 0.4,
    hc_canny_high: float = 1.1,
    rgb_canny_low: float = 40.0,
    rgb_canny_high: float = 100.0,
) -> torch.Tensor:
    """Edge-type bit labels [capacity] int32 (0 = no edge).

    ``edge_types`` selects which labels to compute (reference
    setEdgeType). HIGH_CURVATURE requires normals on the cloud;
    RGB_CANNY requires an ``rgb`` attr (gray = mean channel, reference
    scale 0..255 for the default thresholds)."""
    h, w = cloud.height, cloud.width
    if h <= 1 or w <= 1 or h * w != cloud.capacity:
        raise ValueError("organized_edge_detection requires an organized cloud")
    dev = cloud.xyz.device
    z = cloud.xyz[:, 2].reshape(h, w)
    finite = (cloud.mask & torch.isfinite(cloud.xyz[:, 2])).reshape(h, w)
    zabs = torch.where(finite, z, 0.0).abs()
    th = float(np.float32(depth_discon_threshold))

    labels = torch.zeros((h, w), dtype=torch.int32, device=dev)
    interior = torch.zeros((h, w), dtype=torch.bool, device=dev)
    interior[1:-1, 1:-1] = True

    if edge_types & (EDGELABEL_NAN_BOUNDARY | EDGELABEL_OCCLUDING
                     | EDGELABEL_OCCLUDED):
        nbr_valid = torch.stack([_shift(finite, dc, dr, False) for dc, dr in _DIRS])
        nbr_dist = torch.stack([zabs - _shift(zabs, dc, dr, 0.0) for dc, dr in _DIRS])
        all_valid = nbr_valid.all(0)

        # --- all-neighbors-valid: dominant signed depth difference
        mn = nbr_dist.min(0).values
        mx = nbr_dist.max(0).values
        dominant = torch.where(mn.abs() > mx.abs(), mn, mx)
        discon = dominant.abs() > th * zabs
        base = finite & interior & all_valid & discon
        occluded = base & (dominant > 0.0)
        occluding = base & (dominant <= 0.0)

        # --- some invalid neighbors: march across the NaN region along
        # the mean invalid direction (hpp:160-216)
        dx, dy = march_steps(~nbr_valid)
        rows = torch.arange(h, device=dev, dtype=torch.int32)[:, None].expand(h, w)
        cols = torch.arange(w, device=dev, dtype=torch.int32)[None, :].expand(h, w)
        zflat = zabs.reshape(-1)
        fflat = finite.reshape(-1)
        active = finite & interior & ~all_valid
        inv_base = active
        corr = torch.full((h, w), torch.nan, dtype=torch.float32, device=dev)
        for s in range(1, max_search_neighbors):
            sf = float(s)
            srow = rows + xla_int32(torch.floor(dy * sf))
            scol = cols + xla_int32(torch.floor(dx * sf))
            inb = (srow >= 0) & (srow < h) & (scol >= 0) & (scol < w)
            idx = torch.clamp(srow.long() * w + scol.long(), 0, h * w - 1)
            zs = zflat[idx]
            fs = fflat[idx] & inb
            corr = torch.where(active & fs, zs, corr)
            active = active & ~fs & inb        # out-of-bounds = break
        found = torch.isfinite(corr)
        dist = zabs - corr
        discon2 = dist.abs() > th * zabs
        occluded = occluded | (inv_base & found & discon2 & (dist > 0.0))
        occluding = occluding | (inv_base & found & discon2 & (dist <= 0.0))
        nan_boundary = inv_base & ~found

        zero = torch.zeros((), dtype=torch.int32, device=dev)
        if edge_types & EDGELABEL_OCCLUDED:
            labels = labels | torch.where(occluded, EDGELABEL_OCCLUDED, zero)
        if edge_types & EDGELABEL_OCCLUDING:
            labels = labels | torch.where(occluding, EDGELABEL_OCCLUDING, zero)
        if edge_types & EDGELABEL_NAN_BOUNDARY:
            labels = labels | torch.where(nan_boundary, EDGELABEL_NAN_BOUNDARY, zero)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if edge_types & EDGELABEL_HIGH_CURVATURE:
        if ATTR_NORMAL not in cloud.attrs:
            raise ValueError("HIGH_CURVATURE edges require normals")
        nrm = cloud.attrs[ATTR_NORMAL]
        hc = img_ops.canny_from_gradients(nrm[:, 0].reshape(h, w), nrm[:, 1].reshape(h, w),
                                          hc_canny_low, hc_canny_high)
        labels = labels | torch.where(hc, EDGELABEL_HIGH_CURVATURE, zero)

    if edge_types & EDGELABEL_RGB_CANNY:
        if ATTR_RGB not in cloud.attrs:
            raise ValueError("RGB_CANNY edges require an rgb attr")
        rgb = cloud.attrs[ATTR_RGB].to(torch.float32)
        gray = ((rgb[:, 0] + rgb[:, 1] + rgb[:, 2]) * _THIRD).reshape(h, w)
        ce = img_ops.canny(gray, rgb_canny_low, rgb_canny_high)
        labels = labels | torch.where(ce, EDGELABEL_RGB_CANNY, zero)

    return labels.reshape(-1)


def edge_label_indices(labels, n_types: int = 5):
    """Per-edge-type index lists (assignLabelIndices, hpp:66): a list of
    n_types int arrays — indices whose label has bit ``t`` set."""
    lab = labels.cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
    return [np.flatnonzero((lab >> t) & 1) for t in range(n_types)]
