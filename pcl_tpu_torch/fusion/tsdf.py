"""TSDF volume: integration, raycast, surface extraction.

Counterpart of ``pcl_tpu/fusion/tsdf.py`` (PCL's KinFu ``tsdf23`` integration
and ray caster, and ``createVMap``/``createNMap``). The volume is a dense
``[R, R, R]`` pair (tsdf, weight) on the device; world to grid is an
axis-aligned scale and offset; the camera is a pinhole; poses are 4x4
camera-to-world.

- ``integrate`` updates every voxel by the same expression as the reference,
  one x-slab of at most ``_SLAB_VOXELS`` voxels at a time: the update is per
  voxel, so the output is that of one pass over the volume, without the
  ``[R, R, R, 3]`` temporaries (1.6 GB each at R = 512). A voxel's camera
  coordinates are the sum of three per-axis terms. Pixel indices are clamped
  to ``[-1, W]`` before the cast, so a voxel near the camera plane maps outside
  the frame on every device.
- ``raycast`` marches each pixel's ray in ``n_steps`` fixed steps, as the
  reference does, but samples ``_MARCH_STEPS`` steps at once and takes the
  first zero crossing among them: the same arithmetic per step, in
  ``n_steps / _MARCH_STEPS`` passes instead of ``n_steps``. The eight
  trilinear corners are added in the reference's order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from pcl_tpu_torch.core.cloud import _device

_SLAB_VOXELS = 1 << 22
_MARCH_STEPS = 16


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


@dataclasses.dataclass(frozen=True)
class TSDFVolume:
    tsdf: torch.Tensor        # [R,R,R] f32 in [-1, 1]
    weight: torch.Tensor      # [R,R,R] f32
    origin: torch.Tensor      # [3] world position of voxel (0,0,0)'s corner
    voxel_size: torch.Tensor  # scalar f32
    trunc: torch.Tensor       # scalar f32 truncation distance

    @property
    def resolution(self) -> int:
        return self.tsdf.shape[0]


def make_volume(resolution: int, size: float, origin=None, trunc: Optional[float] = None,
                device=None) -> TSDFVolume:
    """An empty volume of ``resolution^3`` voxels covering ``size`` metres a
    side, on ``device`` (default CUDA); truncation 7 voxels unless given."""
    dev = _device(device)
    voxel = size / resolution
    if trunc is None:
        trunc = 7.0 * voxel
    if origin is None:
        origin = (0.0, 0.0, 0.0)
    return TSDFVolume(
        tsdf=torch.ones((resolution,) * 3, dtype=torch.float32, device=dev),
        weight=torch.zeros((resolution,) * 3, dtype=torch.float32, device=dev),
        origin=torch.as_tensor(origin, dtype=torch.float32).to(dev),
        voxel_size=torch.tensor(voxel, dtype=torch.float32, device=dev),
        trunc=torch.tensor(trunc, dtype=torch.float32, device=dev),
    )


def _pixel(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest pixel index (half to even, as ``jnp.round``), ``-1`` or
    ``size`` where the coordinate lies outside ``[-1, size]``."""
    return torch.round(torch.clamp(coord, -1.0, float(size))).to(torch.int64)


def integrate(
    vol: TSDFVolume,
    depth: torch.Tensor,          # [H,W] f32 metres; <= 0 invalid
    intr: Intrinsics,
    pose: torch.Tensor,           # [4,4] camera-to-world
    max_weight: float = 128.0,
) -> TSDFVolume:
    """Fuse one depth frame: project each voxel centre into the frame,
    ``sdf = depth(px) - z_cam``, clipped to the truncation band, running
    weighted average; a new volume."""
    R = vol.resolution
    H, W = depth.shape
    dev = depth.device
    w2c = torch.linalg.inv(pose)
    Rm, t = w2c[:3, :3], w2c[:3, 3]
    centre = torch.arange(R, dtype=torch.float32, device=dev) + 0.5
    world = [vol.origin[a] + centre * vol.voxel_size for a in range(3)]
    # camera coordinate c of voxel (x, y, z): ax[c][x] + ay[c][y] + az[c][z] + t[c]
    ax, ay, az = (Rm[:, a, None] * world[a] for a in range(3))      # [3, R] each
    flat_depth = depth.reshape(-1)
    tsdf = torch.empty_like(vol.tsdf)
    weight = torch.empty_like(vol.weight)
    step = max(1, _SLAB_VOXELS // (R * R))
    for x0 in range(0, R, step):
        x1 = min(R, x0 + step)

        def cam(c):
            return (ax[c, x0:x1, None, None] + ay[c, None, :, None]) + az[c, None, None, :] + t[c]

        z = cam(2)
        zs = torch.clamp(z, min=1e-9)
        ui = _pixel(intr.fx * cam(0) / zs + intr.cx, W)
        vi = _pixel(intr.fy * cam(1) / zs + intr.cy, H)
        inb = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        d = flat_depth[torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)]
        sdf = d - z
        tsdf_new = torch.clamp(sdf / vol.trunc, -1.0, 1.0)
        update = inb & (d > 0) & (sdf >= -vol.trunc)
        t_old, w_old = vol.tsdf[x0:x1], vol.weight[x0:x1]
        w_add = update.to(torch.float32)
        weight[x0:x1] = torch.clamp(w_old + w_add, max=max_weight)
        tsdf[x0:x1] = torch.where(
            update, (t_old * w_old + tsdf_new) / torch.clamp(w_old + w_add, min=1e-9), t_old)
    return dataclasses.replace(vol, tsdf=tsdf, weight=weight)


def _sample_tsdf(vol: TSDFVolume, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear TSDF sample at world points ``[..., 3]``: ``(value, inside)``."""
    R = vol.resolution
    g = (pts - vol.origin) / vol.voxel_size - 0.5
    g0 = torch.floor(g)
    f = g - g0
    g0 = g0.to(torch.int64)
    inside = torch.all((g0 >= 0) & (g0 < R - 1), dim=-1)
    g0 = torch.clamp(g0, 0, R - 2)
    base = (g0[..., 0] * R + g0[..., 1]) * R + g0[..., 2]
    flat = vol.tsdf.reshape(-1)
    val = None
    for dx in (0, 1):
        wx = f[..., 0] if dx else 1.0 - f[..., 0]
        for dy in (0, 1):
            wy = f[..., 1] if dy else 1.0 - f[..., 1]
            for dz in (0, 1):
                wz = f[..., 2] if dz else 1.0 - f[..., 2]
                c = flat[base + (dx * R + dy) * R + dz] * wx * wy * wz
                val = c if val is None else val + c
    return val, inside


def raycast(
    vol: TSDFVolume,
    intr: Intrinsics,
    pose: torch.Tensor,           # [4,4] camera-to-world
    height: int,
    width: int,
    near: float = 0.1,
    far: float = 5.0,
    n_steps: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render ``(vertex_map [H,W,3] world frame, normal_map [H,W,3], hit
    [H,W])`` by marching each pixel's ray to its first + to - zero crossing."""
    dev = pose.device
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    dirs = torch.stack([(u + 0.5 - intr.cx) / intr.fx, (v + 0.5 - intr.cy) / intr.fy,
                        torch.ones_like(u)], dim=-1)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs = dirs @ pose[:3, :3].T
    org = pose[:3, 3]
    step = (far - near) / n_steps

    t_hit = torch.full((height, width), torch.inf, dtype=torch.float32, device=dev)
    prev_val = torch.ones((height, width), dtype=torch.float32, device=dev)
    found = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for i0 in range(0, n_steps, _MARCH_STEPS):
        ts = near + torch.arange(i0, min(n_steps, i0 + _MARCH_STEPS), dtype=torch.float32,
                                 device=dev) * step                     # [K]
        tk = ts[:, None, None]
        val, inside = _sample_tsdf(vol, org + tk[..., None] * dirs)     # [K,H,W]
        val = torch.where(inside, val, 1.0)
        prev = torch.cat([prev_val[None], val[:-1]])
        crossing = (prev > 0) & (val <= 0)
        t_cross = tk - step + step * prev / torch.clamp(prev - val, min=1e-9)
        first = torch.argmax(crossing.to(torch.uint8), dim=0, keepdim=True)  # the earliest
        new = torch.any(crossing, dim=0) & ~found
        t_hit = torch.where(new, torch.gather(t_cross, 0, first)[0], t_hit)
        found = found | new
        prev_val = val[-1]
    hit = found
    verts = org + torch.where(hit, t_hit, 0.0)[..., None] * dirs
    # normals: central differences of the TSDF field, one voxel either side
    eye = torch.eye(3, dtype=torch.float32, device=dev) * vol.voxel_size
    g = torch.stack([_sample_tsdf(vol, verts + eye[a])[0] - _sample_tsdf(vol, verts - eye[a])[0]
                     for a in range(3)], dim=-1)
    n = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-12)
    flip = torch.sum(n * dirs, dim=-1) > 0
    n = torch.where(flip[..., None], -n, n)
    return (torch.where(hit[..., None], verts, 0.0), torch.where(hit[..., None], n, 0.0), hit)


def extract_surface_points(vol: TSDFVolume, max_points: int = 1 << 18,
                           iso_band: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Observed voxel centres with ``|tsdf| < iso_band``, the first
    ``max_points`` in index order: ``(points [max_points, 3], valid)``."""
    R = vol.resolution
    sel = (torch.abs(vol.tsdf) < iso_band) & (vol.weight > 0)
    idx = torch.nonzero(sel.reshape(-1))[:max_points, 0]
    n = idx.shape[0]
    chosen = torch.zeros(max_points, dtype=torch.int64, device=idx.device)
    chosen[:n] = idx
    valid = torch.arange(max_points, device=idx.device) < n
    grid = torch.stack([chosen // (R * R), (chosen // R) % R, chosen % R], dim=-1)
    pts = vol.origin + (grid.to(torch.float32) + 0.5) * vol.voxel_size
    return torch.where(valid[:, None], pts, 0.0), valid


def depth_to_vertex_map(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """``[H,W]`` depth -> ``[H,W,3]`` camera-frame vertices (createVMap).
    The focal lengths divide as tensors on the depth's device: CUDA divides
    by a host scalar as a product with its reciprocal, which rounds apart
    from the CPU's (and the JAX package's) quotient."""
    H, W = depth.shape
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                          torch.arange(W, dtype=torch.float32, device=depth.device),
                          indexing="ij")
    fx, fy = (torch.tensor(f, dtype=torch.float32, device=depth.device)
              for f in (intr.fx, intr.fy))
    return torch.stack([(u - intr.cx) * depth / fx, (v - intr.cy) * depth / fy, depth], dim=-1)


def vertex_map_normals(vmap: torch.Tensor) -> torch.Tensor:
    """``[H,W,3]`` vertices -> ``[H,W,3]`` normals by the cross product of
    the image-grid forward differences, wrapping at the last row and column
    as the reference does (createNMap)."""
    dx = torch.roll(vmap, -1, dims=1) - vmap
    dy = torch.roll(vmap, -1, dims=0) - vmap
    n = torch.linalg.cross(dx, dy)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return torch.where(norm > 1e-12, n / torch.clamp(norm, min=1e-12), 0.0)
