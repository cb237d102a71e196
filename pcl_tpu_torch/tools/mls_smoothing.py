"""CLI: moving-least-squares smoothing with normals (counterpart of
``pcl_tpu/tools/mls_smoothing.py``).

    python -m pcl_tpu_torch.tools.mls_smoothing in.pcd out.pcd [-radius 0.02] [-polynomial_order 2] [-sqr_gauss_param g] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="MLS smoothing + normal estimation")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-radius", type=float, default=0.02, help="search radius")
    ap.add_argument("-polynomial_order", type=int, default=2, choices=(1, 2))
    ap.add_argument("-sqr_gauss_param", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.surface import moving_least_squares

    c = io.load(args.input, device=args.device)
    out = moving_least_squares(c, args.radius, polynomial_order=args.polynomial_order,
                               sqr_gauss_param=args.sqr_gauss_param, compute_normals=True)
    io.save(args.output, out)
    print(f"[mls_smoothing] smoothed {int(out.count)} points "
          f"(radius {args.radius}, order {args.polynomial_order})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
