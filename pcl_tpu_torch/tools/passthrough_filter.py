"""CLI: passthrough filter (counterpart of
``pcl_tpu/tools/passthrough_filter.py``; reference:
tools/passthrough_filter.cpp).

    python -m pcl_tpu_torch.tools.passthrough_filter in.pcd out.pcd [-field z] [-min a] [-max b] [--negative] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Filter points by a field range")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-field", default="z")
    ap.add_argument("-min", type=float, default=float("-inf"))
    ap.add_argument("-max", type=float, default=float("inf"))
    ap.add_argument("--negative", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.filters import pass_through
    c = io.load(args.input, device=args.device)
    out = pass_through(c, args.field, args.min, args.max, negative=args.negative)
    print(f"[passthrough] {int(c.count)} -> {int(out.count)} points")
    io.save(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
