"""KinFu tracker loop: depth in, pose and fused volume out.

Counterpart of ``pcl_tpu/fusion/kinfu.py`` (PCL's
``kinfuLS::KinfuTracker::operator()``): bilateral filter, depth pyramid,
coarse-to-fine projective point-to-plane ICP against the previous frame's
raycast ({10, 5, 4} iterations finest to coarsest), the tracking-lost check,
integration and raycast. A lost frame keeps the previous pose and is not
integrated.

Every ICP iteration stays on the device with no read-back, as the reference's
fixed ``lax.scan``. The step reads back one value a frame, ``lost``, and skips
the integration when it is set; the reference instead selects between the
old and the new volume on every voxel, which gives the same volume.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from pcl_tpu_torch.core.transforms import se3_exp
from pcl_tpu_torch.filters.convolution import fast_bilateral
from pcl_tpu_torch.fusion.tsdf import (
    Intrinsics, TSDFVolume, _pixel, depth_to_vertex_map, integrate, raycast, vertex_map_normals,
)
from pcl_tpu_torch.registration.estimation import point_to_plane_system

# iterations per pyramid level, index = level (0 = finest), PCL's
# icp_iterations_ {10, 5, 4}
LEVEL_ITERS = (10, 5, 4)


class KinfuState(NamedTuple):
    volume: TSDFVolume
    pose: torch.Tensor          # [4,4] camera-to-world
    prev_verts: torch.Tensor    # [H,W,3] world frame (last raycast)
    prev_normals: torch.Tensor  # [H,W,3]
    prev_hit: torch.Tensor      # [H,W] bool
    frame: torch.Tensor         # int32
    lost: torch.Tensor          # bool: the last frame failed tracking


def kinfu_init(volume: TSDFVolume, height: int, width: int,
               init_pose: Optional[torch.Tensor] = None) -> KinfuState:
    """A tracker on ``volume``'s device, at ``init_pose`` (default the
    identity)."""
    dev = volume.tsdf.device
    if init_pose is None:
        init_pose = torch.eye(4, dtype=torch.float32, device=dev)
    z3 = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    return KinfuState(
        volume=volume,
        pose=init_pose.to(device=dev, dtype=torch.float32),
        prev_verts=z3,
        prev_normals=z3,
        prev_hit=torch.zeros((height, width), dtype=torch.bool, device=dev),
        frame=torch.tensor(0, dtype=torch.int32, device=dev),
        lost=torch.tensor(False, device=dev),
    )


def kinfu_reset(state: KinfuState, volume: TSDFVolume,
                init_pose: Optional[torch.Tensor] = None) -> KinfuState:
    """Restart tracking after a lost frame (PCL's KinfuTracker::reset)."""
    H, W = state.prev_hit.shape
    return kinfu_init(volume, H, W, init_pose)


def _blocks(a: torch.Tensor) -> torch.Tensor:
    """``[H, W, ...]`` -> ``[H//2, 2, W//2, 2, ...]`` (odd last row/column dropped)."""
    H, W = a.shape[:2]
    return a[: H - H % 2, : W - W % 2].reshape((H // 2, 2, W // 2, 2) + a.shape[2:])


def _pyr_down_depth(d: torch.Tensor, sigma_depth: float = 0.1) -> torch.Tensor:
    """Validity- and discontinuity-aware 2x downsample: entries more than
    ``sigma_depth`` from the block's nearest valid depth are left out of its
    average."""
    b = _blocks(d)
    v = b > 0
    ref = torch.amin(torch.where(v, b, torch.inf), dim=(1, 3))
    keep = v & (torch.abs(b - ref[:, None, :, None]) < sigma_depth)
    s = torch.sum(torch.where(keep, b, 0.0), dim=(1, 3))
    c = torch.sum(keep.to(torch.float32), dim=(1, 3))
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), 0.0)


def _pyr_down_map(vm: torch.Tensor, nm: torch.Tensor, hit: torch.Tensor):
    """2x downsample of raycast vertex and normal maps by hit-masked 2x2
    averaging (PCL's resizeVMap/resizeNMap)."""
    w = _blocks(hit).to(torch.float32)[..., None]
    cnt = torch.sum(w, dim=(1, 3))
    v_avg = torch.sum(_blocks(vm) * w, dim=(1, 3)) / torch.clamp(cnt, min=1.0)
    n_sum = torch.sum(_blocks(nm) * w, dim=(1, 3))
    n_avg = n_sum / torch.clamp(torch.linalg.vector_norm(n_sum, dim=-1, keepdim=True), min=1e-12)
    hit2 = cnt[..., 0] > 0
    return (torch.where(hit2[..., None], v_avg, 0.0),
            torch.where(hit2[..., None], n_avg, 0.0), hit2)


def _scale_intrinsics(intr: Intrinsics, level: int) -> Intrinsics:
    s = 0.5 ** level
    return Intrinsics(intr.fx * s, intr.fy * s,
                      (intr.cx + 0.5) * s - 0.5, (intr.cy + 0.5) * s - 0.5)


def _projective_icp(
    verts_cam: torch.Tensor,     # [H,W,3] current frame, camera coordinates
    valid_cur: torch.Tensor,     # [H,W]
    prev_verts: torch.Tensor,    # [H,W,3] world
    prev_normals: torch.Tensor,  # [H,W,3]
    prev_hit: torch.Tensor,      # [H,W]
    pose0: torch.Tensor,         # [4,4] initial camera-to-world
    intr: Intrinsics,
    prev_pose: torch.Tensor,     # [4,4] pose the previous maps were rendered from
    n_iters: int,
    dist_thresh: float,
    angle_thresh: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-to-plane alignment of the current depth against the previous
    raycast by projective data association; ``n_iters`` Gauss-Newton steps.
    Returns ``(pose, n_ok at the last iteration)``."""
    H, W, _ = verts_cam.shape
    dev = verts_cam.device
    w2c_prev = torch.linalg.inv(prev_pose)
    # the last row and column are left out: their forward-difference normals
    # wrap around the frame
    interior = torch.zeros((H, W), dtype=torch.bool, device=dev)
    interior[: H - 1, : W - 1] = True
    cos_gate = torch.cos(torch.tensor(angle_thresh, dtype=torch.float32, device=dev))
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    pose = pose0
    n_ok = torch.tensor(0.0, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        pw = verts_cam @ pose[:3, :3].T + pose[:3, 3]            # world
        pc = pw @ w2c_prev[:3, :3].T + w2c_prev[:3, 3]           # previous camera
        z = pc[..., 2]
        zs = torch.clamp(z, min=1e-9)
        u = _pixel(intr.fx * pc[..., 0] / zs + intr.cx, W)
        v = _pixel(intr.fy * pc[..., 1] / zs + intr.cy, H)
        inb = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        pix = torch.clamp(v, 0, H - 1) * W + torch.clamp(u, 0, W - 1)
        q = prev_verts.reshape(-1, 3)[pix]
        nq = prev_normals.reshape(-1, 3)[pix]
        hit = prev_hit.reshape(-1)[pix]
        d = torch.linalg.vector_norm(pw - q, dim=-1)
        ncur = vertex_map_normals(torch.where(valid_cur[..., None], pw, 0.0))
        cosang = torch.abs(torch.sum(ncur * nq, dim=-1))
        ok = valid_cur & interior & inb & hit & (d < dist_thresh) & (cosang > cos_gate)
        w = ok.to(torch.float32).reshape(-1)
        JtJ, Jtr, _ = point_to_plane_system(pw.reshape(-1, 3), q.reshape(-1, 3),
                                            nq.reshape(-1, 3), w)
        Hm = JtJ + 1e-6 * torch.trace(JtJ) / 6.0 * eye6
        xi = torch.linalg.solve_ex(Hm, -Jtr[:, None])[0][:, 0]
        n_ok = torch.sum(w)
        xi = torch.where((n_ok >= 6) & torch.all(torch.isfinite(xi)), xi, 0.0)
        pose = se3_exp(xi) @ pose
    return pose, n_ok


def _rotation_angle(R: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0))


def kinfu_step(
    state: KinfuState,
    depth: torch.Tensor,         # [H,W] metres; <= 0 invalid
    intr: Intrinsics,
    *,
    levels: int = 3,
    dist_thresh: float = 0.1,
    angle_thresh: float = math.pi / 6,
    bilateral: bool = True,
    max_step_trans: float = 0.3,
    max_step_rot: float = 0.6,
    min_corr_frac: float = 0.05,
) -> KinfuState:
    """One tracking step: bilateral filter, coarse-to-fine ICP, lost check,
    integration and raycast."""
    H, W = depth.shape
    d = torch.where(depth > 0, depth, 0.0)
    if bilateral:
        d = torch.where(depth > 0, fast_bilateral(d), 0.0)

    depths = [d]
    pverts, pnorms, phits = [state.prev_verts], [state.prev_normals], [state.prev_hit]
    for _ in range(1, levels):
        depths.append(_pyr_down_depth(depths[-1]))
        pv, pn, ph = _pyr_down_map(pverts[-1], pnorms[-1], phits[-1])
        pverts.append(pv)
        pnorms.append(pn)
        phits.append(ph)

    first = state.frame == 0
    pose = state.pose
    n_ok = torch.tensor(0.0, dtype=torch.float32, device=depth.device)
    for level in range(levels - 1, -1, -1):
        dl = depths[level]
        il = _scale_intrinsics(intr, level)
        pose, n_ok = _projective_icp(
            depth_to_vertex_map(dl, il), dl > 0, pverts[level], pnorms[level], phits[level],
            pose, il, state.pose, LEVEL_ITERS[min(level, len(LEVEL_ITERS) - 1)],
            dist_thresh, angle_thresh)

    # tracking lost: too few associations, a wild pose jump, or a non-finite pose
    delta = torch.linalg.inv(state.pose) @ pose
    trans = torch.linalg.vector_norm(delta[:3, 3])
    rot = _rotation_angle(delta[:3, :3])
    n_valid = torch.clamp(torch.sum((d > 0).to(torch.float32)), min=1.0)
    lost = (~first) & ((n_ok < min_corr_frac * n_valid) | (trans > max_step_trans)
                       | (rot > max_step_rot) | ~torch.all(torch.isfinite(pose)))
    pose = torch.where(first | lost, state.pose, pose)

    # a lost frame would smear bad geometry into the volume
    vol = state.volume if bool(lost) else integrate(state.volume, d, intr, pose)   # the read-back
    verts, normals, hit = raycast(vol, intr, pose, H, W)
    return KinfuState(volume=vol, pose=pose, prev_verts=verts, prev_normals=normals,
                      prev_hit=hit, frame=state.frame + 1, lost=lost)
