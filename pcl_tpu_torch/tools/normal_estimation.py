"""CLI: normal estimation (counterpart of ``pcl_tpu/tools/normal_estimation.py``).

    python -m pcl_tpu_torch.tools.normal_estimation in.pcd out.pcd -k 16 [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Estimate surface normals")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-k", type=int, default=16)
    ap.add_argument("-vx", type=float, default=0.0)
    ap.add_argument("-vy", type=float, default=0.0)
    ap.add_argument("-vz", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import features, io
    c = io.load(args.input, device=args.device)
    out = features.estimate_normals(c, k=args.k, viewpoint=[args.vx, args.vy, args.vz])
    print(f"[normal_estimation] {int(out.count)} points, k={args.k}")
    io.save(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
