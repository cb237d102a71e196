"""Organized neighbour search: projection-window kNN and radius search for
organized clouds.

Counterpart of ``pcl_tpu/search/organized.py``. ``build`` fits the 3x4
camera projection of the organized cloud on the host (least squares over
pixel/point pairs); ``knn`` projects each query and searches a window of
pixels around it; ``self_knn`` is the self-query form, where every query is
a pixel and the window comes from shifted images. Lists are ascending, the
earlier window position first on a tie (a stable sort).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pcl_tpu_torch.search.bruteforce import smallest_k


class OrganizedSearch(NamedTuple):
    xyz_img: torch.Tensor   # [H, W, 3]
    valid: torch.Tensor     # [H, W] bool
    P: torch.Tensor         # [3, 4] projection matrix


def estimate_projection_matrix(xyz_img: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """DLT least-squares fit of ``u w = P [x, 1]`` over up to 400 valid
    pixels spread evenly over the image."""
    ys, xs = np.nonzero(valid)
    pts = xyz_img[ys, xs]
    n = len(pts)
    sel = np.linspace(0, n - 1, min(n, 400)).astype(int)
    pts, ys, xs = pts[sel], ys[sel], xs[sel]
    Xh = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    A = []
    for (u, v, X) in zip(xs, ys, Xh):
        A.append(np.concatenate([X, np.zeros(4), -u * X]))
        A.append(np.concatenate([np.zeros(4), X, -v * X]))
    _, _, vt = np.linalg.svd(np.asarray(A), full_matrices=False)
    P = vt[-1].reshape(3, 4)
    if (P[2] @ Xh[0]) < 0:          # positive depth scale
        P = -P
    return P.astype(np.float32)


def build(xyz_img: torch.Tensor, valid: torch.Tensor) -> OrganizedSearch:
    """Organized search over an ``[H, W, 3]`` image; the projection is
    fitted on a host copy and kept on the image's device."""
    P = estimate_projection_matrix(xyz_img.detach().cpu().numpy(),
                                   valid.detach().cpu().numpy())
    return OrganizedSearch(xyz_img.to(torch.float32), valid.to(torch.bool),
                           torch.from_numpy(P).to(xyz_img.device))


def knn(
    search: OrganizedSearch, queries: torch.Tensor, k: int, window: int = 9
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(flat pixel indices [Q, k] int32, sqdist [Q, k], valid [Q, k])``
    from the ``window x window`` pixels around each query's projection."""
    H, W = search.valid.shape
    dev = queries.device
    qh = torch.cat([queries, torch.ones_like(queries[:, :1])], dim=1)
    proj = qh @ search.P.T
    z = torch.where(torch.abs(proj[:, 2]) > 1e-12, proj[:, 2], 1e-12)
    ui = torch.clamp(torch.round(proj[:, 0] / z).to(torch.int32), 0, W - 1)
    vi = torch.clamp(torch.round(proj[:, 1] / z).to(torch.int32), 0, H - 1)
    r = window // 2
    off = torch.arange(-r, r + 1, dtype=torch.int32, device=dev)
    dy = off[:, None].expand(window, window).reshape(-1)
    dx = off[None, :].expand(window, window).reshape(-1)
    yy = torch.clamp(vi[:, None] + dy[None, :], 0, H - 1).long()
    xx = torch.clamp(ui[:, None] + dx[None, :], 0, W - 1).long()
    diff = search.xyz_img[yy, xx] - queries[:, None, :]
    sq = diff * diff
    d2 = torch.where(search.valid[yy, xx], (sq[..., 0] + sq[..., 1]) + sq[..., 2], math.inf)
    dd, col = smallest_k(d2, k)
    flat = (torch.gather(yy, 1, col) * W + torch.gather(xx, 1, col)).to(torch.int32)
    return flat, dd, torch.isfinite(dd)


def self_knn(
    xyz_img: torch.Tensor, valid: torch.Tensor, k: int, window: int = 9
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest neighbours of every pixel among its ``window x window``
    image neighbourhood: ``(flat pixel indices [H*W, k] int32, sqdist,
    valid)``, index 0 where invalid."""
    H, W, _ = xyz_img.shape
    dev = xyz_img.device
    r = window // 2
    yy = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    d2s, offs = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            sh = torch.roll(xyz_img, shifts=(-dy, -dx), dims=(0, 1))
            sv = torch.roll(valid, shifts=(-dy, -dx), dims=(0, 1))
            inb = (yy + dy >= 0) & (yy + dy < H) & (xx + dx >= 0) & (xx + dx < W)
            sq = (sh - xyz_img) ** 2
            d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
            d2s.append(torch.where(sv & inb & valid, d2, math.inf))
            offs.append(dy * W + dx)
    D = torch.stack(d2s, dim=-1).reshape(H * W, len(offs))
    dd, lane = smallest_k(D, k)
    flat = (yy * W + xx).reshape(-1, 1) + torch.tensor(offs, dtype=torch.int32,
                                                       device=dev)[lane]
    ok = torch.isfinite(dd)
    return torch.where(ok, flat, 0), dd, ok


def radius(
    search: OrganizedSearch, queries: torch.Tensor, r: float, cap: int, window: int = 13
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(flat indices [Q, cap], sqdist, valid, count [Q])`` within ``r``."""
    flat, d2, ok = knn(search, queries, cap, window)
    ok = ok & (d2 <= r * r)          # compared in float32, as JAX's weak scalar
    return flat, torch.where(ok, d2, math.inf), ok, torch.sum(ok, dim=1, dtype=torch.int32)
