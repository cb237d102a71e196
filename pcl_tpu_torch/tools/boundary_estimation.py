"""CLI: boundary point detection (counterpart of
``pcl_tpu/tools/boundary_estimation.py``).

    python -m pcl_tpu_torch.tools.boundary_estimation in.pcd out.pcd [-radius 0.03] [-angle 1.5708] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Mark boundary points (angle criterion)")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-radius", type=float, default=0.03)
    ap.add_argument("-angle", type=float, default=1.5708, help="max gap angle (rad)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import features, io
    from pcl_tpu_torch.core.cloud import compact
    c = io.load(args.input, device=args.device)
    c = features.estimate_normals(c, k=16)
    b = features.boundary_estimation(c, radius=args.radius, angle_threshold=args.angle)
    out = compact(c.with_mask(b))
    io.save(args.output, out)
    print(f"[boundary_estimation] {int(c.count)} pts -> {int(out.count)} boundary")
    return 0


if __name__ == "__main__":
    sys.exit(main())
