"""CLI: re-express a cloud in its VIEWPOINT frame (counterpart of
``pcl_tpu/tools/transform_from_viewpoint.py``; reference:
tools/transform_from_viewpoint.cpp). The 4x4 is made in float32 on the host
as the JAX tool makes it (its inverse by numpy); the points are moved on the
device.

    python -m pcl_tpu_torch.tools.transform_from_viewpoint in.pcd out.pcd [--inverse] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Apply the stored viewpoint")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--inverse", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import dataclasses
    import numpy as np
    import torch
    from pcl_tpu_torch.core.transforms import quat_to_matrix, transform_points
    from pcl_tpu_torch.io import pcd as pcd_io
    from pcl_tpu_torch.io.pcd import read_pcd_arrays
    header, _cols = read_pcd_arrays(args.input)
    c = pcd_io.load(args.input, device=args.device)
    t = np.asarray(header.viewpoint[:3], np.float32)
    qw, qx, qy, qz = header.viewpoint[3:]
    R = quat_to_matrix(torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    if args.inverse:
        T = np.linalg.inv(T)
    out = dataclasses.replace(
        c, xyz=transform_points(torch.from_numpy(T).to(c.xyz.device), c.xyz))
    pcd_io.save(args.output, out)
    print(f"[transform_from_viewpoint] t={t.tolist()} inverse={args.inverse}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
