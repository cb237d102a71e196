"""Convolution filters: 3-D point convolution, separable convolutions of
organized clouds, pyramids, the fast bilateral filter, covariance sampling
and surface-normal sampling.

Counterpart of ``pcl_tpu/filters/convolution.py``:

- ``convolution_3d`` (PCL's Convolution3D with a Gaussian kernel): each point
  becomes the Gaussian-weighted mean of its neighbours within ``radius``
  among its ``k`` nearest (the brute k-NN, ``bruteforce.knn``);
- ``convolution_rows`` / ``convolution_cols`` (PCL's Convolution): a 1-D
  kernel along the rows or columns of an organized ``[H, W, ...]`` array,
  borders duplicated, mirrored (numpy's "reflect") or zero ("ignore"); the
  taps are added in kernel order;
- ``pyramid`` (PCL's Pyramid): 5-tap binomial smoothing of the valid pixels
  and 2x decimation per level;
- ``fast_bilateral`` (PCL's ``FastBilateralFilter::applyFilter``; KinFu
  filters each depth frame with it): each pixel is splatted trilinearly into a
  ``[grid_xy, grid_xy, grid_z, 2]`` grid of (depth sum, weight), the grid is
  blurred by ``[1/4, 1/2, 1/4]`` along each axis, and each pixel reads the
  grid back trilinearly. The splat adds with ``index_put_`` and accumulation:
  the eight corners one after another, each in pixel order on both devices (a
  stable sort of the cells on CUDA), which is the order of the reference's
  eight scatters, so a frame filters bit for bit the same on every run;
- ``covariance_sampling`` (PCL's CovarianceSampling) and
  ``sampling_surface_normal`` (SamplingSurfaceNormal) are host numpy in the
  JAX package, and are here: the same numpy arithmetic and draws, so the same
  output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud, make_cloud
from pcl_tpu_torch.ops.segsum import add_rows
from pcl_tpu_torch.search import bruteforce


def _corner_weight(fx, fy, fz, di: int, dj: int, dk: int):
    return (fx if di else 1 - fx) * (fy if dj else 1 - fy) * (fz if dk else 1 - fz)


def fast_bilateral(
    depth: torch.Tensor,
    sigma_s: float = 8.0,
    sigma_r: float = 0.05,
    grid_xy: int = 64,
    grid_z: int = 32,
) -> torch.Tensor:
    """Bilateral-grid smoothing of ``depth [H, W]`` (metres); pixels <= 0
    are invalid and kept as they are."""
    H, W = depth.shape
    dev = depth.device
    valid = depth > 0
    zmin = torch.min(torch.where(valid, depth, torch.inf))

    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] / sigma_s
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] / sigma_s
    gz = (depth - zmin) / sigma_r

    def cells(g, n):
        return torch.clamp(g / torch.clamp(g.max(), min=1e-9) * (n - 2), 0, n - 2)

    nx = cells(gx, grid_xy).expand(H, W)
    ny = cells(gy, grid_xy).expand(H, W)
    nz = cells(gz, grid_z)
    i0, j0, k0 = (xla_int32(torch.floor(a)).to(torch.int64) for a in (nx, ny, nz))
    fx, fy, fz = nx - i0, ny - j0, nz - k0

    grid = torch.zeros((grid_xy, grid_xy, grid_z, 2), dtype=torch.float32, device=dev)
    vw = torch.stack([torch.where(valid, depth, 0.0), valid.to(torch.float32)], -1)
    corners = [(di, dj, dk) for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]
    for di, dj, dk in corners:
        w = _corner_weight(fx, fy, fz, di, dj, dk) * valid
        add_rows(grid, (j0 + dj, i0 + di, k0 + dk), vw * w[..., None])
    for ax in range(3):
        grid = 0.25 * torch.roll(grid, 1, ax) + 0.5 * grid + 0.25 * torch.roll(grid, -1, ax)

    out = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
    for di, dj, dk in corners:
        w = _corner_weight(fx, fy, fz, di, dj, dk)
        out = out + grid[j0 + dj, i0 + di, k0 + dk] * w[..., None]
    sm = out[..., 0] / torch.clamp(out[..., 1], min=1e-9)
    return torch.where(valid, sm, depth)


def convolution_3d(cloud: Cloud, radius: float, sigma: Optional[float] = None,
                   k: int = 32) -> Cloud:
    """Gaussian convolution of the positions (sigma ``radius / 2`` unless
    given) over each point's neighbours within ``radius`` among its ``k``
    nearest; attributes are carried through."""
    s = radius / 2.0 if sigma is None else sigma
    xyz = cloud.xyz
    idx, d2, ok = bruteforce.knn(xyz, cloud.mask, xyz, k)
    ok = ok & (d2 <= radius * radius) & cloud.mask[:, None]
    w = torch.where(ok, torch.exp(-d2 / (2.0 * s * s)), 0.0)
    nb = xyz[torch.clamp(idx.long(), 0, cloud.capacity - 1)]
    wsum = torch.sum(w, dim=1, keepdim=True)
    out = torch.sum(w[..., None] * nb, dim=1) / torch.clamp(wsum, min=1e-12)
    return cloud.with_xyz(torch.where((wsum > 0) & cloud.mask[:, None], out, xyz))


def _padded(img: torch.Tensor, r: int, dim: int, border: str) -> torch.Tensor:
    """``img`` extended by ``r`` entries at both ends of ``dim``."""
    mode = {"duplicate": "edge", "mirror": "reflect", "ignore": "constant"}[border]
    n = img.shape[dim]
    j = torch.arange(-r, n + r, device=img.device)
    if mode == "reflect":
        idx = torch.where(j < 0, -j, torch.where(j >= n, 2 * (n - 1) - j, j))
    else:
        idx = torch.clamp(j, 0, n - 1)
    out = torch.index_select(img, dim, idx)
    if mode == "constant":
        inside = ((j >= 0) & (j < n)).reshape((-1,) + (1,) * (img.ndim - dim - 1))
        out = torch.where(inside, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def _convolve(img: torch.Tensor, kernel, dim: int, border: str) -> torch.Tensor:
    kernel = torch.as_tensor(kernel, dtype=torch.float32).to(img.device)
    k = kernel.shape[0]
    pi = _padded(img, k // 2, dim, border)
    out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for i in range(k):
        out = out + kernel[i] * pi.narrow(dim, i, img.shape[dim]).to(torch.float32)
    return out


def convolution_rows(img: torch.Tensor, kernel, border: str = "duplicate") -> torch.Tensor:
    """1-D convolution along the rows (axis 1) of an organized ``[H, W, ...]``
    array."""
    return _convolve(img, kernel, 1, border)


def convolution_cols(img: torch.Tensor, kernel, border: str = "duplicate") -> torch.Tensor:
    """1-D convolution along the columns (axis 0)."""
    return _convolve(img, kernel, 0, border)


def pyramid(xyz_img: torch.Tensor, valid: torch.Tensor, levels: int = 3):
    """Gaussian pyramid of an organized cloud: ``[(xyz_img, valid)]`` per
    level, the first the input; each next level smooths the valid pixels by
    the binomial 5-tap kernel and keeps every second row and column."""
    kern = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float32) / 16.0
    cur, curv = xyz_img.to(torch.float32), valid
    out = [(xyz_img, valid)]
    for _ in range(levels - 1):
        w = curv.to(torch.float32)[..., None]
        sm = convolution_cols(convolution_rows(cur * w, kern), kern)
        sw = convolution_cols(convolution_rows(w, kern), kern)
        cur = (sm / torch.clamp(sw, min=1e-9))[::2, ::2]
        curv = (sw[::2, ::2, 0] > 0.25) & curv[::2, ::2]
        out.append((cur, curv))
    return out


def covariance_sampling(cloud: Cloud, n_samples: int) -> np.ndarray:
    """Indices of the ``n_samples`` points that best constrain the 6-DoF
    point-to-plane system: each point's ``[p x n, n]`` row scored against the
    three weakest eigenvectors of the 6x6 covariance (host numpy)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("covariance_sampling requires normals")
    xyz = cloud.xyz.cpu().numpy()
    m = cloud.mask.cpu().numpy()
    n = cloud.attrs[ATTR_NORMAL].cpu().numpy()
    c = xyz[m] - xyz[m].mean(0)
    nn = n[m]
    scale = np.abs(c).max() + 1e-12
    f = np.concatenate([np.cross(c / scale, nn), nn], 1)
    _w, v = np.linalg.eigh(f.T @ f)
    score = ((f @ v[:, :3]) ** 2).sum(1)
    return np.flatnonzero(m)[np.argsort(-score)[:n_samples]]


def sampling_surface_normal(cloud: Cloud, cell_size: float, samples_per_cell: int = 4,
                            seed: int = 0) -> Cloud:
    """Voxel partition with a plane fitted per cell: up to
    ``samples_per_cell`` points of each cell of at least 3, drawn by numpy's
    generator from ``seed``, carrying the cell's normal; on the cloud's
    device."""
    dev = cloud.xyz.device
    pts = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
    rng = np.random.default_rng(seed)
    key = np.floor(pts / cell_size).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    out_p, out_n = [], []
    for ci in range(len(uniq)):
        sel = np.flatnonzero(inv == ci)
        if len(sel) < 3:
            continue
        sub = pts[sel]
        c0 = sub.mean(0)
        _w, v = np.linalg.eigh((sub - c0).T @ (sub - c0))
        take = sel if len(sel) <= samples_per_cell else rng.choice(
            sel, samples_per_cell, replace=False)
        out_p.append(pts[take])
        out_n.append(np.tile(v[:, 0], (len(take), 1)))
    if not out_p:
        return make_cloud(np.zeros((1, 3), np.float32), mask=np.zeros(1, bool), device=dev)
    c = make_cloud(np.concatenate(out_p).astype(np.float32), device=dev)
    return c.with_attrs(normal=torch.from_numpy(
        np.concatenate(out_n).astype(np.float32)).to(dev))
