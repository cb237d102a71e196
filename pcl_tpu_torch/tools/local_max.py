"""CLI: remove the points that are local z-maxima (counterpart of
``pcl_tpu/tools/local_max.py``; reference: tools/local_max.cpp).

    python -m pcl_tpu_torch.tools.local_max in.pcd out.pcd [-radius 1.0] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Filter points that are local z-maxima")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-radius", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import compact
    from pcl_tpu_torch.filters.extras import local_maximum
    c = io.load(args.input, device=args.device)
    out = compact(local_maximum(c, args.radius))
    io.save(args.output, out)
    print(f"[local_max] {int(c.count)} -> {int(out.count)} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
