"""CLI: the lowest point of each XY grid cell (counterpart of
``pcl_tpu/tools/grid_min.py``; reference: tools/grid_min.cpp).

    python -m pcl_tpu_torch.tools.grid_min in.pcd out.pcd [-resolution 1.0] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Keep the lowest point per XY grid cell")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-resolution", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import compact
    from pcl_tpu_torch.filters.extras import grid_minimum
    c = io.load(args.input, device=args.device)
    out = compact(grid_minimum(c, args.resolution))
    io.save(args.output, out)
    print(f"[grid_min] {int(c.count)} -> {int(out.count)} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
