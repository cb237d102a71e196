"""CLI: fast bilateral smoothing of organized depth (counterpart of
``pcl_tpu/tools/fast_bilateral_filter.py``; reference:
tools/fast_bilateral_filter.cpp). An unorganized cloud takes the point
bilateral filter instead, as in the JAX tool.

    python -m pcl_tpu_torch.tools.fast_bilateral_filter in.pcd out.pcd [-sigma_s 8.0] [-sigma_r 0.05] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Edge-preserving depth smoothing")
    ap.add_argument("input", help="organized PCD")
    ap.add_argument("output")
    ap.add_argument("-sigma_s", type=float, default=8.0)
    ap.add_argument("-sigma_r", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.filters.convolution import fast_bilateral
    from pcl_tpu_torch.filters.extras import bilateral_filter
    c = io.load(args.input, device=args.device)
    if c.height > 1:
        # organized: filter the z channel in image space (the reference path)
        z = c.xyz[:, 2].reshape(c.height, c.width)
        zs = fast_bilateral(z, sigma_s=args.sigma_s, sigma_r=args.sigma_r)
        scale = (zs / torch.where(z != 0, z, 1.0)).reshape(-1)
        out = c.with_xyz(c.xyz * scale[:, None])
    else:
        print("[fast_bilateral_filter] unorganized input -> point bilateral",
              file=sys.stderr)
        out = bilateral_filter(c, sigma_s=args.sigma_s, sigma_r=args.sigma_r)
    io.save(args.output, out)
    print(f"[fast_bilateral_filter] {int(c.count)} pts "
          f"(sigma_s {args.sigma_s}, sigma_r {args.sigma_r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
