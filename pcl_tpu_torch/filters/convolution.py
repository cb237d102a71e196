"""Edge-preserving depth smoothing on the bilateral grid.

Counterpart of ``fast_bilateral`` in ``pcl_tpu/filters/convolution.py`` (PCL's
``FastBilateralFilter::applyFilter``); KinFu filters each depth frame with it.
The rest of that file (convolutions, pyramids, covariance sampling) is not
ported yet (ROADMAP item 18).

Each pixel is splatted trilinearly into a ``[grid_xy, grid_xy, grid_z, 2]``
grid of (depth sum, weight), the grid is blurred by ``[1/4, 1/2, 1/4]`` along
each axis, and each pixel reads the grid back trilinearly. The splat adds with
``index_put_`` and accumulation: the eight corners one after another, each in
pixel order on both devices (a stable sort of the cells on CUDA), which is the
order of the reference's eight scatters, so a frame filters bit for bit the
same on every run.
"""

from __future__ import annotations

import torch


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
    i0, j0, k0 = (torch.floor(a).to(torch.int64) for a in (nx, ny, nz))
    fx, fy, fz = nx - i0, ny - j0, nz - k0

    grid = torch.zeros((grid_xy, grid_xy, grid_z, 2), dtype=torch.float32, device=dev)
    vw = torch.stack([torch.where(valid, depth, 0.0), valid.to(torch.float32)], -1)
    corners = [(di, dj, dk) for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]
    for di, dj, dk in corners:
        w = _corner_weight(fx, fy, fz, di, dj, dk) * valid
        grid.index_put_((j0 + dj, i0 + di, k0 + dk), vw * w[..., None], accumulate=True)
    for ax in range(3):
        grid = 0.25 * torch.roll(grid, 1, ax) + 0.5 * grid + 0.25 * torch.roll(grid, -1, ax)

    out = torch.zeros((H, W, 2), dtype=torch.float32, device=dev)
    for di, dj, dk in corners:
        w = _corner_weight(fx, fy, fz, di, dj, dk)
        out = out + grid[j0 + dj, i0 + di, k0 + dk] * w[..., None]
    sm = out[..., 0] / torch.clamp(out[..., 1], min=1e-9)
    return torch.where(valid, sm, depth)
