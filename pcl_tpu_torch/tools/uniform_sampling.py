"""CLI: uniform sampling, one input point kept per voxel (counterpart of
``pcl_tpu/tools/uniform_sampling.py``; reference: tools/uniform_sampling.cpp).

    python -m pcl_tpu_torch.tools.uniform_sampling in.pcd out.pcd [-radius 0.01] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Uniform (keep-one-per-voxel) sampling")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-radius", type=float, default=0.01, help="voxel size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.filters import uniform_sample
    c = io.load(args.input, device=args.device)
    out = uniform_sample(c, args.radius)
    print(f"[uniform_sampling] {int(c.count)} -> {int(out.count)} points "
          f"(radius {args.radius})")
    io.save(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
