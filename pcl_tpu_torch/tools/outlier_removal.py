"""CLI: statistical or radius outlier removal (counterpart of
``pcl_tpu/tools/outlier_removal.py``; reference: tools/outlier_removal.cpp).

    python -m pcl_tpu_torch.tools.outlier_removal in.pcd out.pcd [-method statistical|radius] [-mean_k 16] [-std_dev_mul 1.0] [-radius 0.05] [-min_pts 2] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Remove outliers")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-method", default="statistical", choices=["statistical", "radius"])
    ap.add_argument("-mean_k", type=int, default=16)
    ap.add_argument("-std_dev_mul", type=float, default=1.0)
    ap.add_argument("-radius", type=float, default=0.05)
    ap.add_argument("-min_pts", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import filters, io
    c = io.load(args.input, device=args.device)
    if args.method == "statistical":
        out = filters.statistical_outlier_removal(
            c, mean_k=args.mean_k, stddev_mult=args.std_dev_mul)
    else:
        out = filters.radius_outlier_removal(c, radius=args.radius,
                                             min_neighbors=args.min_pts)
    print(f"[outlier_removal] {int(c.count)} -> {int(out.count)} points")
    io.save(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
