"""CLI: radius outlier removal (counterpart of
``pcl_tpu/tools/radius_filter.py``; reference: tools/radius_filter.cpp).

    python -m pcl_tpu_torch.tools.radius_filter in.pcd out.pcd [-radius 0.1] [-min_neighbors 2] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Remove points with few neighbors in r")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-radius", type=float, default=0.1)
    ap.add_argument("-min_neighbors", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import compact
    from pcl_tpu_torch.filters.outliers import radius_outlier_removal
    c = io.load(args.input, device=args.device)
    out = compact(radius_outlier_removal(c, args.radius, args.min_neighbors))
    io.save(args.output, out)
    print(f"[radius_filter] {int(c.count)} -> {int(out.count)} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
