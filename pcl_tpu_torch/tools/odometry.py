"""CLI: sequence odometry and trajectory ATE (counterpart of
``pcl_tpu/tools/odometry.py``).

Usage: python -m pcl_tpu_torch.tools.odometry scan0.pcd scan1.pcd ... \\
         [--method icp|icp_p2plane|gicp|ndt] [--max-corr-dist D] [--iters N]
         [--poses-out poses.txt] [--golden poses.txt] [--device cpu]

Poses are written and read in KITTI format: one row per scan, the 12 values of
the 3x4 [R|t] matrix (world from scan). With --golden, prints the ATE (aligned
and unaligned RMSE) against the given trajectory.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load_poses(path: str) -> np.ndarray:
    rows = np.loadtxt(path, dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None]
    if rows.shape[1] != 12:
        raise ValueError("pose file must have 12 columns (KITTI 3x4 rows)")
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :4] = rows.reshape(-1, 3, 4)
    return poses


def _save_poses(path: str, poses: np.ndarray) -> None:
    np.savetxt(path, np.asarray(poses)[:, :3, :4].reshape(len(poses), 12),
               fmt="%.9g")


_GICP_K = 20     # gicp's k_covariances


def probed_cells(source, target, method: str, max_corr_dist: float) -> dict:
    """The cell-list arguments of ``icp`` and ``gicp`` for one pair, from the
    host density probe ``search.auto_cell_params``: the cap of the
    correspondence table (cells of twice the gate) and, for GICP, the cell
    size and cap of the covariance neighbourhoods, each measured on the hashed
    table the aligner builds. The aligners' own defaults (32 slots, and for
    the covariances the density radius of the bounding box, metres wide on a
    street scan that is mostly air) overflow on outdoor scans and report
    ``truncated``; the JAX package's CLI runs on those defaults."""
    from pcl_tpu_torch import search

    kw = {}
    if np.isfinite(max_corr_dist):
        kw["cell_cap"] = search.auto_cell_params(target, 1, 2.0 * max_corr_dist)[1]
    if method == "gicp":
        cell = max(search.auto_cell_params(c, _GICP_K)[0] for c in (source, target))
        kw["cov_cell_size"] = cell
        kw["cov_cell_cap"] = max(search.auto_cell_params(c, _GICP_K, cell)[1]
                                 for c in (source, target))
    return kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Sequence odometry + ATE")
    ap.add_argument("scans", nargs="+", help="PCD files, in order")
    ap.add_argument("--method", default="gicp",
                    choices=["icp", "icp_p2plane", "gicp", "ndt"])
    ap.add_argument("--max-corr-dist", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--resolution", type=float, default=1.0,
                    help="NDT voxel resolution")
    ap.add_argument("--poses-out", help="write KITTI-format poses here")
    ap.add_argument("--golden", help="KITTI-format golden poses for ATE")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pcl_tpu_torch import features, io
    from pcl_tpu_torch.registration import gicp, icp, ndt, odometry_sequence, trajectory_ate
    from pcl_tpu_torch.utils.timing import StopWatch

    clouds = [io.load(p, device=args.device) for p in args.scans]
    print(f"[odometry] {len(clouds)} scans, method={args.method}",
          file=sys.stderr)

    if args.method == "gicp":
        def register(s, t):
            return gicp(s, t, max_corr_dist=args.max_corr_dist,
                        max_iterations=args.iters,
                        **probed_cells(s, t, "gicp", args.max_corr_dist))
    elif args.method == "ndt":
        def register(s, t):
            return ndt(s, t, resolution=args.resolution,
                       max_iterations=args.iters)
    else:
        variant = ("point_to_plane" if args.method == "icp_p2plane"
                   else "point_to_point")
        if variant == "point_to_plane":
            clouds = [features.estimate_normals(c, k=16) for c in clouds]

        def register(s, t):
            return icp(s, t, max_corr_dist=args.max_corr_dist,
                       max_iterations=args.iters, variant=variant,
                       **probed_cells(s, t, "icp", args.max_corr_dist))

    sw = StopWatch()
    poses = odometry_sequence(clouds, register=register)   # reads every pose back
    dt = sw.ms()
    print(f"[odometry] {len(poses)} poses in {dt:.1f} ms "
          f"({dt / max(len(poses) - 1, 1):.1f} ms/pair)", file=sys.stderr)

    if args.poses_out:
        _save_poses(args.poses_out, poses)
        print(f"[odometry] wrote {args.poses_out}", file=sys.stderr)

    if args.golden:
        golden = _load_poses(args.golden)
        a = trajectory_ate(poses, golden, align=True)
        u = trajectory_ate(poses, golden, align=False)
        print(f"ATE rmse={a.rmse:.6g} m (aligned)  "
              f"rmse={u.rmse:.6g} m (unaligned)  max={a.max:.6g} m")
    else:
        t = np.asarray(poses)[:, :3, 3]
        print(f"trajectory length: "
              f"{np.linalg.norm(np.diff(t, axis=0), axis=1).sum():.6g} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
