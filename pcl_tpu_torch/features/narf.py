"""NARF: range-image borders, keypoints and the 36-value descriptor.

Counterpart of ``pcl_tpu/features/narf.py`` (reference
RangeImageBorderExtractor, NarfKeypoint, NarfDescriptor). Everything stays
on the ``[H, W]`` range image: borders and interest are shifted-image
stencils, the descriptor a gather of beam samples.

- ``narf_keypoints`` ranks the score with one stable descending sort, so
  equal scores (the ``-inf`` of every pixel that is no peak among them)
  come lowest index first, as ``lax.top_k`` gives them (ROADMAP C8, C74);
- the descriptor's sample offsets truncate toward zero, as the JAX
  package's ``astype(int32)`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.range_image import RangeImage

_EPS = 1e-12

# border classes
BORDER_NONE = 0
BORDER_OBSTACLE = 1     # foreground edge (surface ends, big jump behind)
BORDER_SHADOW = 2       # background pixel adjacent to an obstacle border


class BorderDescription(NamedTuple):
    border_type: torch.Tensor    # [H, W] int32 BORDER_*
    border_score: torch.Tensor   # [H, W] f32 in [0, 1]


def _neighbor(img: torch.Tensor, dr: int, dc: int, fill=math.inf) -> torch.Tensor:
    """``out[r, c] = img[r + dr, c + dc]``, ``fill`` outside."""
    out = torch.full_like(img, fill)
    H, W = img.shape
    rs = slice(max(dr, 0), H + min(dr, 0))
    rd = slice(max(-dr, 0), H + min(-dr, 0))
    cs = slice(max(dc, 0), W + min(dc, 0))
    cd = slice(max(-dc, 0), W + min(-dc, 0))
    out[rd, cd] = img[rs, cs]
    return out


def _observed(r: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(r) & (r > 0)


def extract_borders(ri: RangeImage, threshold: float = 0.5) -> BorderDescription:
    """Borders from relative range jumps to the nearest observed pixel
    within 3 steps in each of the 4 directions (reference
    getNeighborDistanceChangeScore): the near side of a jump is an obstacle
    border, the far side a shadow."""
    r = ri.ranges
    observed = _observed(r)
    r_safe = torch.where(observed, r, math.inf)
    score = torch.zeros_like(r)
    shadow = torch.zeros_like(r, dtype=torch.bool)
    for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        rn = torch.full_like(r, math.inf)
        found = torch.zeros_like(r, dtype=torch.bool)
        for step in range(1, 4):
            cand = _neighbor(r_safe, dr * step, dc * step, math.inf)
            take = ~found & torch.isfinite(cand)
            rn = torch.where(take, cand, rn)
            found = found | take
        s = torch.where(found, 1.0 - r_safe / torch.clamp(rn, min=_EPS), 0.0)
        score = torch.maximum(score, torch.clamp(s, 0.0, 1.0))
        s_back = torch.where(found, 1.0 - rn / torch.clamp(r_safe, min=_EPS), 0.0)
        shadow = shadow | (s_back > threshold)
    score = torch.where(observed, score, 0.0)
    btype = torch.where(score > threshold, BORDER_OBSTACLE, BORDER_NONE)
    btype = torch.where(observed & shadow & (btype == BORDER_NONE), BORDER_SHADOW, btype)
    return BorderDescription(btype.to(torch.int32), score)


def narf_interest_image(ri: RangeImage, support: int = 3,
                        border_threshold: float = 0.5) -> torch.Tensor:
    """Interest ``[H, W]``: range curvature in 4 directions at ``support``
    pixels, raised near obstacle borders (reference narf_keypoint.h)."""
    r = ri.ranges
    observed = _observed(r)
    borders = extract_borders(ri, border_threshold)
    r0 = torch.where(observed, r, 0.0)
    interest = torch.zeros_like(r)
    for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        rp = _neighbor(r0, dr * support, dc * support, 0.0)
        rm = _neighbor(r0, -dr * support, -dc * support, 0.0)
        op = _neighbor(observed, dr * support, dc * support, False)
        om = _neighbor(observed, -dr * support, -dc * support, False)
        ok = observed & op & om
        curv = torch.abs(rp + rm - 2 * r0) / torch.clamp(r0, min=_EPS)
        interest = torch.maximum(interest, torch.where(ok, curv, 0.0))
    b = (borders.border_type == BORDER_OBSTACLE).to(torch.float32)
    near_b = b
    for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        near_b = torch.maximum(near_b, 0.7 * _neighbor(b, dr, dc, 0.0))
    interest = torch.clamp(10.0 * interest, 0.0, 1.0)
    interest = torch.maximum(interest, near_b * borders.border_score)
    return torch.where(observed, interest, 0.0)


def narf_keypoints(
    ri: RangeImage,
    *,
    max_keypoints: int = 128,
    min_interest: float = 0.45,
    nms_radius: int = 3,
    support: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NARF keypoints: the peaks of the interest image over a ``(2 nms + 1)^2``
    window at least ``min_interest``, ranked. Returns ``(pixel_rc [K, 2]
    int32, interest [K], valid [K])``, ``K = max_keypoints``; invalid slots
    hold the lowest-index pixels of score ``-inf``, as in the JAX package."""
    interest = narf_interest_image(ri, support)
    m = interest
    for dr in range(-nms_radius, nms_radius + 1):
        for dc in range(-nms_radius, nms_radius + 1):
            if dr == 0 and dc == 0:
                continue
            m = torch.maximum(m, _neighbor(interest, dr, dc, 0.0))
    is_peak = (interest >= m) & (interest >= min_interest)
    score = torch.where(is_peak, interest, -math.inf).reshape(-1)
    W = interest.shape[1]
    vals, flat = torch.sort(score, descending=True, stable=True)
    vals, flat = vals[:max_keypoints], flat[:max_keypoints]
    rc = torch.stack([flat // W, flat % W], dim=-1).to(torch.int32)
    valid = torch.isfinite(vals) & (vals > 0)
    return rc, torch.where(valid, vals, 0.0), valid


def narf_descriptors(
    ri: RangeImage,
    pixel_rc: torch.Tensor,         # [K, 2] keypoint pixels
    *,
    n_beams: int = 36,
    patch_radius: int = 10,
    n_steps: int = 8,
    rotation_invariant: bool = True,
) -> torch.Tensor:
    """NARF descriptor ``[K, n_beams]`` (reference NarfDescriptor): each cell
    the mean range change along one beam of a star pattern, range-normalised
    and squashed by ``atan``; rotation invariance rolls the strongest beam
    to position 0."""
    r = ri.ranges
    H, W = r.shape
    dev = r.device
    observed = _observed(r)
    r0 = torch.where(observed, r, 0.0)
    angles = torch.arange(n_beams, dtype=torch.float32, device=dev) / n_beams * 2 * math.pi
    steps = (torch.arange(n_steps, dtype=torch.float32, device=dev) + 1.0) / n_steps \
        * patch_radius
    dr = torch.sin(angles)[:, None] * steps[None, :]          # [n_beams, n_steps]
    dc = torch.cos(angles)[:, None] * steps[None, :]
    pixel_rc = pixel_rc.long()
    kr = pixel_rc[:, 0].to(torch.float32)
    kc = pixel_rc[:, 1].to(torch.float32)
    sr = torch.clamp(xla_int32(kr[:, None, None] + dr[None]), 0, H - 1).long()
    sc = torch.clamp(xla_int32(kc[:, None, None] + dc[None]), 0, W - 1).long()
    samp = r0[sr, sc]                                         # [K, n_beams, n_steps]
    samp_ok = observed[sr, sc]
    center = r0[pixel_rc[:, 0], pixel_rc[:, 1]][:, None, None]
    delta = torch.where(samp_ok, (samp - center) / torch.clamp(center, min=_EPS), 0.0)
    cnt = torch.clamp(samp_ok.sum(-1), min=1)
    desc = delta.sum(-1) / cnt
    desc = torch.atan(desc) / (0.5 * math.pi)
    if rotation_invariant:
        shift = torch.argmax(torch.abs(desc), dim=-1)
        idx = (torch.arange(n_beams, device=dev)[None, :] + shift[:, None]) % n_beams
        desc = torch.gather(desc, 1, idx)
    return desc
