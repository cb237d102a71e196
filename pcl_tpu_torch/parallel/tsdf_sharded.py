"""Sharded TSDF fusion: the volume split into x-slabs over the ranks, with
halo planes exchanged between neighbours.

Counterpart of ``pcl_tpu/parallel/tsdf_sharded.py`` (kinfu_large_scale's
cyclical buffer re-derived for a sharded volume):

- ``sharded_integrate``: each rank fuses its slab against the whole depth
  frame, with no communication; its slab's x offset is its axis position
  times the slab width. The arithmetic is the JAX sharded body's: camera
  coordinates ``world @ w2c[:3, :3].T + t`` per voxel (written out per
  component, so that a voxel's value does not depend on how many voxels are
  computed at once), rounding half to even, then the cast (ROADMAP C27
  bounds its parity with the JAX package). Voxels are computed in pieces of
  ``_SLAB_VOXELS`` along x.
- ``sharded_raycast``: each rank extends its slab by ``halo`` planes from
  either neighbour (one batch of point-to-point sends, the JAX ``ppermute``
  pair), marches every ray but trusts only samples whose trilinear support
  lies in its extended slab, takes the first crossing over all ranks by a
  min-reduce, and sums the normals of the ranks that own the hit (one
  all-reduce of gradient and count). Exact against the replicated raycast
  when ``halo * voxel >= step + voxel``; ``raycast_sharded`` derives such a
  halo from the step.
- ``sharded_shift_x``: the one-slab +x advance: every rank receives its +x
  neighbour's slab (one ring step of point-to-point sends), the last rank's
  slab enters empty, and the evicted slab of rank 0 reaches every rank by a
  masked all-reduce, for the world model.

A volume argument may hold the whole ``[R, R, R]`` volume (every rank the
same) or, as these functions return it, the rank's ``[R / n, R, R]`` slab.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pcl_tpu_torch.fusion.tsdf import (
    _MARCH_STEPS,
    _SLAB_VOXELS,
    Intrinsics,
    TSDFVolume,
    _pixel,
)
from pcl_tpu_torch.parallel.mesh import (
    POINTS_AXIS,
    Axis,
    Mesh,
    _axis_index,
    _axis_size,
    _pmin,
    _ppermute,
    _psum,
    _shard,
)


def _local_slab(mesh: Mesh, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's x-slab of a whole cubic volume, or ``x`` itself when it
    is already a slab."""
    n, R = _axis_size(mesh, axis), x.shape[1]
    if R % n:
        raise ValueError(f"a volume of {R} planes does not split into {n} slabs")
    if x.shape[0] == R:
        return _shard(mesh, x, axis)
    if x.shape[0] * n != R:
        raise ValueError(f"a slab of {x.shape[0]} planes is not 1/{n} of {R}")
    return x.to(mesh.device)


def _integrate_slab(tsdf, weight, x0, origin, voxel_size, trunc, depth, w2c, fx, fy, cx, cy):
    Rl, Ry, Rz = tsdf.shape
    H, W = depth.shape
    dev = tsdf.device
    Rm, t = w2c[:3, :3], w2c[:3, 3]
    wy = (origin[1] + (torch.arange(Ry, dtype=torch.float32, device=dev) + 0.5)
          * voxel_size)[None, :, None]
    wz = (origin[2] + (torch.arange(Rz, dtype=torch.float32, device=dev) + 0.5)
          * voxel_size)[None, None, :]
    flat_depth = depth.reshape(-1)
    t_out, w_out = torch.empty_like(tsdf), torch.empty_like(weight)
    step = max(1, _SLAB_VOXELS // (Ry * Rz))
    for a in range(0, Rl, step):
        b = min(Rl, a + step)
        gx = torch.arange(a, b, dtype=torch.float32, device=dev) + float(x0)
        wx = (origin[0] + (gx + 0.5) * voxel_size)[:, None, None]

        def cam(c):
            return ((wx * Rm[c, 0] + wy * Rm[c, 1]) + wz * Rm[c, 2]) + t[c]

        z = cam(2)
        zs = torch.clamp(z, min=1e-9)
        ui = _pixel(fx * cam(0) / zs + cx, W)
        vi = _pixel(fy * cam(1) / zs + cy, H)
        inb = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        d = flat_depth[torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)]
        sdf = d - z
        t_new = torch.clamp(sdf / trunc, -1.0, 1.0)
        update = inb & (d > 0) & (sdf >= -trunc)
        t_old, w_old = tsdf[a:b], weight[a:b]
        w_add = update.to(torch.float32)
        w_out[a:b] = torch.clamp(w_old + w_add, max=128.0)
        t_out[a:b] = torch.where(
            update, (t_old * w_old + t_new) / torch.clamp(w_old + w_add, min=1e-9), t_old)
    return t_out, w_out


def sharded_integrate(mesh: Mesh, axis: Axis = POINTS_AXIS):
    """A sharded integrate: ``fn(tsdf, weight, origin, voxel_size, trunc,
    depth, w2c, fx, fy, cx, cy) -> (tsdf, weight)`` of this rank's slab; the
    depth frame and the world-to-camera transform are whole on every rank."""

    def fn(tsdf, weight, origin, voxel_size, trunc, depth, w2c, fx, fy, cx, cy):
        tsdf, weight = _local_slab(mesh, tsdf, axis), _local_slab(mesh, weight, axis)
        x0 = _axis_index(mesh, axis) * tsdf.shape[0]
        dev = mesh.device
        return _integrate_slab(tsdf, weight, x0, origin.to(dev), voxel_size.to(dev),
                               trunc.to(dev), depth.to(dev), w2c.to(dev), fx, fy, cx, cy)

    return fn


def integrate_sharded(mesh: Mesh, vol: TSDFVolume, depth: torch.Tensor, intr: Intrinsics,
                      pose: torch.Tensor, axis: Axis = POINTS_AXIS) -> TSDFVolume:
    """Fuse one depth frame into the sharded volume: a volume holding this
    rank's slab."""
    w2c = torch.linalg.inv(pose.to(mesh.device))
    t, w = sharded_integrate(mesh, axis)(
        vol.tsdf, vol.weight, vol.origin, vol.voxel_size, vol.trunc, depth, w2c,
        intr.fx, intr.fy, intr.cx, intr.cy)
    dev = mesh.device
    return dataclasses.replace(vol, tsdf=t, weight=w, origin=vol.origin.to(dev),
                               voxel_size=vol.voxel_size.to(dev), trunc=vol.trunc.to(dev))


def _ring_perm(n: int, shift: int):
    """Source -> destination pairs sending each rank's payload to
    ``(rank + shift) % n``."""
    return [(i, (i + shift) % n) for i in range(n)]


def sharded_raycast(
    mesh: Mesh,
    height: int,
    width: int,
    *,
    axis: Axis = POINTS_AXIS,
    halo: int = 4,
    near: float = 0.1,
    far: float = 5.0,
    n_steps: int = 256,
):
    """A sharded raycast over x-slabs: ``fn(tsdf, origin, voxel_size, fx, fy,
    cx, cy, pose) -> (verts [H,W,3], normals [H,W,3], hit [H,W])``, the same
    on every rank.

    A crossing that straddles a slab boundary is found by the rank whose
    extended slab (its slab and ``halo`` planes a side) holds both samples'
    trilinear support, which holds when ``halo * voxel_size >= step +
    voxel_size`` (``raycast_sharded`` picks such a halo)."""
    step = (far - near) / n_steps

    def fn(tsdf, origin, voxel_size, fx, fy, cx, cy, pose):
        dev = mesh.device
        tsdf = _local_slab(mesh, tsdf, axis)
        origin, voxel_size, pose = origin.to(dev), voxel_size.to(dev), pose.to(dev)
        n_dev, my = _axis_size(mesh, axis), _axis_index(mesh, axis)
        Rl, Ry, Rz = tsdf.shape
        Rg = Rl * n_dev
        x0 = my * Rl
        # the left neighbour's last planes and the right neighbour's first
        left_halo, = _ppermute(mesh, [tsdf[Rl - halo:]], axis, _ring_perm(n_dev, +1))
        right_halo, = _ppermute(mesh, [tsdf[:halo]], axis, _ring_perm(n_dev, -1))
        # ext plane e holds global plane x0 - halo + e (the ring's wrap-around
        # aliases planes outside the global volume, which the gate masks)
        flat = torch.cat([left_halo, tsdf, right_halo]).reshape(-1)

        def sample(pts):
            """Trilinear sample at world ``pts [..., 3]``: ``(value, known)``;
            known where the support lies in the extended slab or the point
            lies outside the global volume (value +1 there)."""
            g = (pts - origin) / voxel_size - 0.5
            g0f = torch.floor(g)
            f = g - g0f
            g0 = g0f.to(torch.int64)
            gx, gy, gz = g0[..., 0], g0[..., 1], g0[..., 2]
            inside_g = ((gx >= 0) & (gx < Rg - 1) & (gy >= 0) & (gy < Ry - 1)
                        & (gz >= 0) & (gz < Rz - 1))
            in_ext = (gx >= x0 - halo) & (gx + 1 <= x0 + Rl - 1 + halo)
            e0 = torch.clamp(gx - (x0 - halo), 0, Rl + 2 * halo - 2)
            base = (e0 * Ry + torch.clamp(gy, 0, Ry - 2)) * Rz + torch.clamp(gz, 0, Rz - 2)
            val = None
            for dx in (0, 1):
                wx = f[..., 0] if dx else 1.0 - f[..., 0]
                for dy in (0, 1):
                    wy = f[..., 1] if dy else 1.0 - f[..., 1]
                    for dz in (0, 1):
                        wz = f[..., 2] if dz else 1.0 - f[..., 2]
                        c = flat[base + (dx * Ry + dy) * Rz + dz] * wx * wy * wz
                        val = c if val is None else val + c
            return torch.where(inside_g, val, 1.0), ~inside_g | in_ext

        v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                              torch.arange(width, dtype=torch.float32, device=dev),
                              indexing="ij")
        dirs = torch.stack([(u + 0.5 - cx) / fx, (v + 0.5 - cy) / fy, torch.ones_like(u)],
                           dim=-1)
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        dirs = dirs @ pose[:3, :3].T
        org = pose[:3, 3]

        t_hit = torch.full((height, width), torch.inf, dtype=torch.float32, device=dev)
        prev_val = torch.ones((height, width), dtype=torch.float32, device=dev)
        prev_known = torch.ones((height, width), dtype=torch.bool, device=dev)
        found = torch.zeros((height, width), dtype=torch.bool, device=dev)
        # _MARCH_STEPS steps at a time; the first crossing of a chunk is the
        # one a step-by-step march would keep
        for i0 in range(0, n_steps, _MARCH_STEPS):
            ts = near + torch.arange(i0, min(n_steps, i0 + _MARCH_STEPS),
                                     dtype=torch.float32, device=dev) * step
            tk = ts[:, None, None]
            val, known = sample(org + tk[..., None] * dirs)
            prev = torch.cat([prev_val[None], val[:-1]])
            pknown = torch.cat([prev_known[None], known[:-1]])
            crossing = pknown & known & (prev > 0) & (val <= 0)
            t_cross = tk - step + step * prev / torch.clamp(prev - val, min=1e-9)
            first = torch.argmax(crossing.to(torch.uint8), dim=0, keepdim=True)
            new = torch.any(crossing, dim=0) & ~found
            t_hit = torch.where(new, torch.gather(t_cross, 0, first)[0], t_hit)
            found = found | new
            prev_val, prev_known = val[-1], known[-1]

        # the first crossing over the mesh; the ranks that found it own it
        t_glob = _pmin(mesh, t_hit, axis)
        hit = torch.isfinite(t_glob)
        owner = found & (t_hit <= t_glob)
        verts = org + torch.where(hit, t_glob, 0.0)[..., None] * dirs
        # normals: central differences, by the owners, summed over the mesh
        eye = torch.eye(3, dtype=torch.float32, device=dev) * voxel_size
        g, g_ok = [], owner
        for a in range(3):
            va, ka = sample(verts + eye[a])
            vb, kb = sample(verts - eye[a])
            g.append(va - vb)
            g_ok = g_ok & ka & kb
        g = torch.where(g_ok[..., None], torch.stack(g, dim=-1), 0.0)
        gc = _psum(mesh, torch.cat([g, g_ok.to(torch.float32)[..., None]], dim=-1), axis)
        g, cnt = gc[..., :3] / torch.clamp(gc[..., 3:], min=1.0), gc[..., 3]
        nrm = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-12)
        nrm = torch.where((torch.sum(nrm * dirs, dim=-1) > 0)[..., None], -nrm, nrm)
        # rays whose owners all lacked gradient support face the camera
        nrm = torch.where((hit & (cnt == 0))[..., None], -dirs, nrm)
        return (torch.where(hit[..., None], verts, 0.0), torch.where(hit[..., None], nrm, 0.0),
                hit)

    return fn


def raycast_sharded(
    mesh: Mesh,
    vol: TSDFVolume,
    intr: Intrinsics,
    pose: torch.Tensor,
    height: int,
    width: int,
    *,
    axis: Axis = POINTS_AXIS,
    near: float = 0.1,
    far: float = 5.0,
    n_steps: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raycast the sharded volume with a halo of ``max(2, int(step / voxel)
    + 2)`` planes, wide enough for the step length."""
    step = (far - near) / n_steps
    voxel = float(vol.voxel_size)
    halo = max(2, int(step / voxel) + 2)
    Rl = vol.tsdf.shape[1] // _axis_size(mesh, axis)
    if halo > Rl:
        raise ValueError(
            f"halo {halo} exceeds slab width {Rl}: raise n_steps or volume "
            f"resolution (step {step:.4f} m, voxel {voxel:.4f} m)")
    fn = sharded_raycast(mesh, height, width, axis=axis, halo=halo,
                         near=near, far=far, n_steps=n_steps)
    return fn(vol.tsdf, vol.origin, vol.voxel_size, intr.fx, intr.fy, intr.cx, intr.cy,
              pose.to(torch.float32))


def sharded_shift_x(mesh: Mesh, axis: Axis = POINTS_AXIS):
    """A one-slab +x advance: ``fn(tsdf, weight) -> (tsdf', weight',
    evicted_tsdf, evicted_weight)``. Rank i's new slab is rank i+1's old one;
    the last rank's slab enters empty (tsdf 1, weight 0); the evicted slab
    (rank 0's old one) is returned on every rank. The caller advances
    ``origin.x`` by a slab's width."""

    def fn(tsdf, weight):
        tsdf, weight = _local_slab(mesh, tsdf, axis), _local_slab(mesh, weight, axis)
        n_dev, my = _axis_size(mesh, axis), _axis_index(mesh, axis)
        # every rank sends its slab one step left
        t_in, w_in = _ppermute(mesh, [tsdf, weight], axis, _ring_perm(n_dev, -1))
        last = my == n_dev - 1
        t_new = torch.ones_like(tsdf) if last else t_in
        w_new = torch.zeros_like(weight) if last else w_in
        # what the last rank received is rank 0's evicted slab: to every rank
        # by the sum of a copy that only the last rank fills
        tw = torch.stack([t_in, w_in]) if last else torch.zeros((2,) + tuple(tsdf.shape),
                                                                dtype=tsdf.dtype,
                                                                device=tsdf.device)
        ev_t, ev_w = _psum(mesh, tw, axis)
        return t_new, w_new, ev_t, ev_w

    return fn


def shift_sharded(mesh: Mesh, vol: TSDFVolume, axis: Axis = POINTS_AXIS
                  ) -> Tuple[TSDFVolume, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance the sharded volume one slab along +x: ``(vol', evicted_tsdf
    [Rl,R,R], evicted_weight, evicted_origin [3])``; push the evicted slab
    into a ``fusion.world_model.WorldModel``."""
    dev = mesh.device
    t, w, ev_t, ev_w = sharded_shift_x(mesh, axis)(vol.tsdf, vol.weight)
    origin, voxel = vol.origin.to(dev), vol.voxel_size.to(dev)
    shift_m = t.shape[0] * voxel
    new_origin = origin + torch.tensor([1.0, 0.0, 0.0], device=dev) * shift_m
    return (dataclasses.replace(vol, tsdf=t, weight=w, origin=new_origin, voxel_size=voxel,
                                trunc=vol.trunc.to(dev)),
            ev_t, ev_w, origin)
