"""CLI: apply a rigid transform to a cloud (counterpart of
``pcl_tpu/tools/transform_point_cloud.py``; reference:
tools/transform_point_cloud.cpp). The 4x4 is made in float64 on the host as
the JAX tool makes it; the points are moved on the device.

    python -m pcl_tpu_torch.tools.transform_point_cloud in.pcd out.pcd [-trans tx,ty,tz] [-axisangle ax,ay,az,theta] [-quat x,y,z,w] [-matrix m00,...,m33] [-scale s] [--device cpu]
"""
import argparse
import math
import sys

import numpy as np


def _rotation_from_axisangle(ax, ay, az, theta):
    v = np.array([ax, ay, az], np.float64)
    n = np.linalg.norm(v)
    if n == 0:
        return np.eye(3)
    v = v / n
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)


def _rotation_from_quat(x, y, z, w):
    q = np.array([x, y, z, w], np.float64)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def main(argv=None):
    ap = argparse.ArgumentParser(description="Apply a rigid transform to a cloud")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-trans", default=None,
                    help="tx,ty,tz translation")
    ap.add_argument("-axisangle", default=None,
                    help="ax,ay,az,theta rotation about an axis (radians)")
    ap.add_argument("-quat", default=None, help="x,y,z,w quaternion rotation")
    ap.add_argument("-matrix", default=None,
                    help="16 comma-separated values, row-major 4x4")
    ap.add_argument("-scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.transforms import transform_points

    T = np.eye(4)
    if args.matrix:
        T = np.array([float(v) for v in args.matrix.split(",")]).reshape(4, 4)
    if args.quat:
        T[:3, :3] = _rotation_from_quat(*[float(v) for v in args.quat.split(",")])
    if args.axisangle:
        T[:3, :3] = _rotation_from_axisangle(
            *[float(v) for v in args.axisangle.split(",")])
    if args.trans:
        T[:3, 3] = [float(v) for v in args.trans.split(",")]
    if args.scale != 1.0:
        T[:3, :3] *= args.scale

    c = io.load(args.input, device=args.device)
    out = c.with_xyz(transform_points(
        torch.as_tensor(T, dtype=torch.float32, device=c.xyz.device), c.xyz))
    io.save(args.output, out)
    print(f"[transform] {args.input} -> {args.output}")
    print(np.array2string(T, precision=6, suppress_small=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
