"""2-D corner detectors on image intensities: AGAST/FAST, BRISK and
Trajkovic (PCL's ``AgastKeypoint2D``, ``BriskKeypoint2D`` with its
descriptor, and ``TrajkovicKeypoint2D``).

Counterpart of ``pcl_tpu/keypoints/corners2d.py``. AGAST runs the 16-pixel
segment test at every pixel at once (16 rolled copies of the image, the
longest brighter or darker arc by a running count over the doubled ring),
scores a corner by its arc's summed contrast and keeps 3 x 3 maxima; BRISK
runs it on a pyramid of 2 x 2 means; the descriptor compares smoothed
intensities at every pair of a fixed pattern of 24 points (numpy, seed 5);
Trajkovic's score is the least over four directions of the two opposite
pixels' squared differences.
"""

from __future__ import annotations

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.ops.nn1 import _fma32

# the 16-pixel Bresenham circle of radius 3 (the AGAST/FAST ring)
_RING = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    np.int32,
)
# XLA divides by the constant 5 as a product with its float32 reciprocal (ROADMAP C79)
_FIFTH = float(np.float32(1.0) / np.float32(5.0))


def _roll2(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(torch.roll(img, dy, 0), dx, 1)


def agast_score(img: torch.Tensor, threshold: float, arc_length: int = 9) -> torch.Tensor:
    """``[H, W]`` corner score: where the longest contiguous arc of ring
    pixels brighter (or darker) than the centre by ``threshold`` is at least
    ``arc_length``, the sum of ``|I_ring - I| - threshold`` over the ring
    pixels beyond the threshold; 0 elsewhere."""
    ring = torch.stack([_roll2(img, -int(dy), -int(dx)) for dy, dx in _RING])
    thr = torch.tensor(threshold, dtype=torch.float32, device=img.device)
    brighter = ring > img[None] + thr
    darker = ring < img[None] - thr

    def longest_arc(mask):
        m2 = torch.cat([mask, mask], dim=0).to(torch.int32)
        run = torch.zeros_like(m2[0])
        best = run
        for row in m2:
            run = (run + 1) * row
            best = torch.maximum(best, run)
        return torch.clamp(best, max=16)

    is_corner = (longest_arc(brighter) >= arc_length) | (longest_arc(darker) >= arc_length)
    mag = torch.sum(torch.where(brighter | darker, torch.abs(ring - img[None]) - thr, 0.0), dim=0)
    return torch.where(is_corner, mag, 0.0)


def _nms3x3(score: torch.Tensor) -> torch.Tensor:
    neigh = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                neigh = torch.maximum(neigh, _roll2(score, dy, dx))
    return (score > 0) & (score >= neigh)


def _agast(img: torch.Tensor, threshold: float, arc_length: int):
    """The score with the 3-pixel border (where the ring wraps) zeroed, and
    its 3 x 3 maxima."""
    s = agast_score(img, threshold, arc_length)
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    border = (yy < 3) | (yy >= H - 3) | (xx < 3) | (xx >= W - 3)
    s = torch.where(border, 0.0, s)
    return s, _nms3x3(s)


def _image(img, device) -> torch.Tensor:
    if torch.is_tensor(img):
        return img.to(torch.float32)
    return torch.as_tensor(np.asarray(img, np.float32), device=_device(device))


def agast_keypoints(img, threshold: float = 10.0, arc_length: int = 9,
                    device=None) -> np.ndarray:
    """``[K, 2]`` (y, x) int32 corners after non-maximum suppression. A numpy
    image goes to ``device`` (default CUDA); a tensor stays where it is."""
    _, keep = _agast(_image(img, device), float(threshold), arc_length)
    return torch.nonzero(keep).to(torch.int32).cpu().numpy().reshape(-1, 2)


def brisk_keypoints(img, threshold: float = 10.0, octaves: int = 3, arc_length: int = 9,
                    device=None) -> np.ndarray:
    """``[K, 3]`` (y, x, octave): AGAST with NMS on each level of a pyramid
    of 2 x 2 means, in full-resolution coordinates."""
    out = []
    cur = _image(img, device)
    for o in range(octaves):
        _, keep = _agast(cur, float(threshold), arc_length)
        yx = torch.nonzero(keep).cpu().numpy().reshape(-1, 2)
        scale = 1 << o
        out.append(np.stack([yx[:, 0] * scale, yx[:, 1] * scale,
                             np.full(len(yx), o)], 1))
        H, W = cur.shape
        cur = cur[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2).mean((1, 3))
        if min(cur.shape) < 16:
            break
    return np.concatenate(out).astype(np.int32) if out else np.zeros((0, 3), np.int32)


def _brisk_pattern(n_points: int = 24, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    r = rng.uniform(2.0, 12.0, n_points)
    th = rng.uniform(0, 2 * np.pi, n_points)
    return np.stack([r * np.sin(th), r * np.cos(th)], 1)  # (dy, dx)


def _smooth_twice(im: torch.Tensor) -> torch.Tensor:
    """Two passes of the 5-point mean as XLA's CPU code forms them inside
    the JAX package's descriptor: every mean is its sum times the float32
    reciprocal of 5 (ROADMAP C79), and in the second pass the centre's
    product is fused into the first addition, ``fma(s_c, 1/5, v_1) + v_2 +
    v_3 + v_4``, the rolled terms ``v`` rounded first (C82)."""
    def five(x):
        return [x, torch.roll(x, 1, 0), torch.roll(x, -1, 0), torch.roll(x, 1, 1),
                torch.roll(x, -1, 1)]

    f = five(im)
    s1 = f[0] + f[1] + f[2] + f[3] + f[4]
    v = five(s1 * _FIFTH)
    acc = _fma32(s1, torch.full_like(im, _FIFTH), v[1]) + v[2] + v[3] + v[4]
    return acc * _FIFTH


def brisk_descriptor(img, keypoints: np.ndarray, device=None) -> np.ndarray:
    """``[K, 276]`` bool: for every pair ``i < j`` of the pattern's 24
    points about each keypoint, whether the twice-smoothed image at ``i`` is
    the brighter."""
    im = _image(img, device)
    sm = _smooth_twice(im)
    H, W = im.shape
    pattern = torch.tensor(_brisk_pattern(), dtype=torch.float32, device=im.device)
    kps = torch.as_tensor(np.asarray(keypoints)[:, :2], dtype=torch.float32, device=im.device)
    pos = kps[:, None, :] + pattern[None, :, :]                  # [K, P, 2]
    yi = torch.clamp(xla_int32(torch.round(pos[..., 0])), 0, H - 1).long()
    xi = torch.clamp(xla_int32(torch.round(pos[..., 1])), 0, W - 1).long()
    vals = sm[yi, xi]
    iu, ju = np.triu_indices(24, 1)
    return (vals[:, iu] > vals[:, ju]).cpu().numpy()


def trajkovic_score(img: torch.Tensor) -> torch.Tensor:
    """``[H, W]``: the least over the four directions ``d`` of ``(I(p + d) -
    I(p))^2 + (I(p - d) - I(p))^2``."""
    resp = None
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        a = _roll2(img, -dy, -dx) - img
        b = _roll2(img, dy, dx) - img
        r = a * a + b * b
        resp = r if resp is None else torch.minimum(resp, r)
    return resp


def trajkovic_keypoints(img, threshold: float = 100.0, device=None) -> np.ndarray:
    """``[K, 2]`` (y, x) int32: 3 x 3 maxima of the score above
    ``threshold``, two pixels off the border."""
    s = trajkovic_score(_image(img, device))
    keep = _nms3x3(torch.where(s > threshold, s, 0.0)).cpu().numpy()
    keep[:2, :] = keep[-2:, :] = False
    keep[:, :2] = keep[:, -2:] = False
    yy, xx = np.nonzero(keep)
    return np.stack([yy, xx], 1).astype(np.int32)
