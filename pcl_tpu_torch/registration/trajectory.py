"""Trajectory evaluation (ATE / RPE) and sequence odometry.

Counterpart of ``pcl_tpu/registration/trajectory.py``, the port's own copy:
the standard trajectory metrics (Sturm et al., TUM RGB-D benchmark
definitions), a function that chains scans through a pairwise aligner into
absolute poses, and the two synthetic odometry fixtures. Everything but the
aligner is host-side numpy: trajectories are a handful of 4x4 poses. Each
pairwise transform is read back once, as float64.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud


class ATEResult(NamedTuple):
    rmse: float          # root-mean-square translational error (the ATE)
    mean: float
    median: float
    max: float
    errors: np.ndarray   # [M] per-pose translational error
    alignment: np.ndarray  # [4,4] SE(3) applied to the estimate before
                           # comparison (identity when align=False)


class RPEResult(NamedTuple):
    trans_rmse: float    # m per delta
    rot_rmse: float      # rad per delta
    trans_errors: np.ndarray
    rot_errors: np.ndarray


def _poses_array(poses) -> np.ndarray:
    p = np.asarray(poses, dtype=np.float64)
    if p.ndim != 3 or p.shape[1:] != (4, 4):
        raise ValueError(f"poses must be [M,4,4], got {p.shape}")
    return p


def umeyama_se3(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Closed-form rigid alignment src -> dst over [M,3] point sets
    (Umeyama without scale — the same estimator the SVD transformation
    estimation uses, reference transformation_estimation_svd.hpp:137-186)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def trajectory_ate(poses, golden, align: bool = True) -> ATEResult:
    """Absolute trajectory error between estimated and golden [M,4,4] poses.

    ``align=True`` first rigidly aligns the estimated trajectory to the
    golden one (SE(3) Umeyama over the translation parts) — the standard
    ATE definition, invariant to the free gauge of the first pose;
    ``align=False`` compares in the shared frame directly (appropriate when
    both trajectories are anchored at the same first pose).
    """
    P = _poses_array(poses)
    G = _poses_array(golden)
    if P.shape[0] != G.shape[0]:
        raise ValueError("trajectory length mismatch")
    est_t = P[:, :3, 3]
    gt_t = G[:, :3, 3]
    if align and P.shape[0] >= 3:
        A = umeyama_se3(est_t, gt_t)
    else:
        A = np.eye(4)
    est_al = est_t @ A[:3, :3].T + A[:3, 3]
    err = np.linalg.norm(est_al - gt_t, axis=1)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        errors=err,
        alignment=A,
    )


def _rot_angle(R: np.ndarray) -> float:
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.arccos(c))


def trajectory_rpe(poses, golden, delta: int = 1) -> RPEResult:
    """Relative pose error over a fixed frame delta: drift per step,
    independent of global alignment."""
    P = _poses_array(poses)
    G = _poses_array(golden)
    if P.shape[0] != G.shape[0]:
        raise ValueError("trajectory length mismatch")
    te, re = [], []
    for i in range(P.shape[0] - delta):
        dp = np.linalg.inv(P[i]) @ P[i + delta]
        dg = np.linalg.inv(G[i]) @ G[i + delta]
        e = np.linalg.inv(dg) @ dp
        te.append(np.linalg.norm(e[:3, 3]))
        re.append(_rot_angle(e[:3, :3]))
    te = np.asarray(te)
    re = np.asarray(re)
    return RPEResult(
        trans_rmse=float(np.sqrt(np.mean(te ** 2))) if len(te) else 0.0,
        rot_rmse=float(np.sqrt(np.mean(re ** 2))) if len(re) else 0.0,
        trans_errors=te,
        rot_errors=re,
    )


def _host_transform(T) -> np.ndarray:
    """A 4x4 transform (tensor on any device, or array) as float64 numpy."""
    if isinstance(T, torch.Tensor):
        return T.detach().cpu().double().numpy()
    return np.asarray(T, np.float64)


def odometry_sequence(
    clouds: Sequence[Cloud],
    register: Optional[Callable] = None,
    init_deltas: Optional[Sequence] = None,
    **icp_kwargs,
) -> np.ndarray:
    """Chain scans through a pairwise aligner -> [M,4,4] absolute poses.

    Pose k maps scan k's frame into scan 0's frame (the odometry
    convention of IncrementalRegistration, reference
    incremental_registration.h:75: abs_k = abs_{k-1} @ T(k, k-1)).
    ``register(source, target[, init])`` must return a result with a
    ``.transform`` 4x4 mapping source into target's frame — any of
    icp/gicp/ndt qualifies. ``init_deltas`` optionally seeds each pairwise
    step (e.g. constant-velocity prediction).
    """
    if register is None:
        from pcl_tpu_torch.registration.icp import icp as _icp

        def register(s, t, init=None):
            if init is not None:
                init = torch.as_tensor(init, dtype=torch.float32, device=s.xyz.device)
            return _icp(s, t, init_transform=init, **icp_kwargs)

    poses = [np.eye(4, dtype=np.float64)]
    prev = None
    for k, cloud in enumerate(clouds):
        if prev is None:
            prev = cloud
            continue
        init = None if init_deltas is None else init_deltas[k - 1]
        res = register(cloud, prev, init) if init is not None \
            else register(cloud, prev)
        poses.append(poses[-1] @ _host_transform(res.transform))
        prev = cloud
    return np.stack(poses)


def make_virtual_scan_sequence(
    scene_xyz: np.ndarray,
    n_scans: int,
    rng: np.random.Generator,
    step_translation: float = 0.05,
    step_rotation: float = 0.02,
    fov_tan: float = 1.2,
    z_range: tuple = (0.3, 8.0),
    max_points: int = 60000,
    noise: float = 0.002,
) -> tuple:
    """Virtual-scanner odometry fixture over a REAL scene cloud (the
    reference's tools/virtual_scanner.cpp analog, VERDICT r3 #4): a
    camera walks a smooth random trajectory through the scene; each scan
    is the scene expressed in the camera frame, cropped to the camera's
    view frustum (|x|,|y| <= fov_tan*z, z in z_range), subsampled to
    ``max_points`` and perturbed by ``noise``. Returns (scans, golden
    camera poses [M,4,4] with pose_k mapping scan k's frame into scan 0's
    frame) — partial overlapping views with ground truth, unlike
    make_drift_sequence's full-scene copies."""
    from scipy.spatial.transform import Rotation

    M = n_scans
    poses = [np.eye(4)]
    for _ in range(M - 1):
        ax = rng.normal(size=3)
        ax /= max(np.linalg.norm(ax), 1e-9)
        ang = rng.uniform(0.3, 1.0) * step_rotation
        dt = rng.normal(size=3)
        dt *= step_translation / max(np.linalg.norm(dt), 1e-9)
        D = np.eye(4)
        D[:3, :3] = Rotation.from_rotvec(ax * ang).as_matrix()
        D[:3, 3] = dt
        poses.append(poses[-1] @ D)
    poses = np.stack(poses)
    scans = []
    for k in range(M):
        inv = np.linalg.inv(poses[k])
        s = scene_xyz @ inv[:3, :3].T + inv[:3, 3]
        z = s[:, 2]
        vis = (z > z_range[0]) & (z < z_range[1]) \
            & (np.abs(s[:, 0]) <= fov_tan * z) \
            & (np.abs(s[:, 1]) <= fov_tan * z)
        s = s[vis]
        if len(s) > max_points:
            s = s[rng.choice(len(s), max_points, replace=False)]
        if noise > 0:
            s = s + rng.normal(scale=noise, size=s.shape)
        scans.append(s.astype(np.float32))
    return scans, poses.astype(np.float64)


def make_drift_sequence(
    scene_xyz: np.ndarray,
    n_scans: int,
    rng: np.random.Generator,
    step_translation: float = 0.02,
    step_rotation: float = 0.02,
    noise: float = 0.0,
) -> tuple:
    """Synthetic odometry fixture: view a static scene from a random-walk
    trajectory. Returns (scans [list of [N,3] f32], golden_poses [M,4,4]):
    scan_k = T_k^{-1}(scene) + noise, so an exact odometry chain recovers
    T_k. The walk is smooth (random axis, bounded step) like a handheld
    sweep."""
    from scipy.spatial.transform import Rotation

    M = n_scans
    poses = [np.eye(4)]
    for _ in range(M - 1):
        ax = rng.normal(size=3)
        ax /= max(np.linalg.norm(ax), 1e-9)
        ang = rng.uniform(0.3, 1.0) * step_rotation
        dt = rng.normal(size=3)
        dt *= step_translation / max(np.linalg.norm(dt), 1e-9)
        D = np.eye(4)
        D[:3, :3] = Rotation.from_rotvec(ax * ang).as_matrix()
        D[:3, 3] = dt
        poses.append(poses[-1] @ D)
    poses = np.stack(poses)
    scans = []
    for k in range(M):
        inv = np.linalg.inv(poses[k])
        s = scene_xyz @ inv[:3, :3].T + inv[:3, 3]
        if noise > 0:
            s = s + rng.normal(scale=noise, size=s.shape)
        scans.append(s.astype(np.float32))
    return scans, poses.astype(np.float64)
