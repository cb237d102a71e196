"""CLI: progressive morphological ground extraction (counterpart of
``pcl_tpu/tools/progressive_morphological_filter.py``; reference:
tools/progressive_morphological_filter.cpp).

    python -m pcl_tpu_torch.tools.progressive_morphological_filter in.pcd out.pcd [-cell_size 1.0] [-max_window 33] [-slope 1.0] [-initial_distance 0.15] [-max_distance 3.0] [--extract_negative] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Extract ground returns from LiDAR")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-cell_size", type=float, default=1.0)
    ap.add_argument("-max_window", type=int, default=33)
    ap.add_argument("-slope", type=float, default=1.0)
    ap.add_argument("-initial_distance", type=float, default=0.15)
    ap.add_argument("-max_distance", type=float, default=3.0)
    ap.add_argument("--extract_negative", action="store_true",
                    help="keep non-ground instead")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import dataclasses
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import compact
    from pcl_tpu_torch.filters.morphological import progressive_morphological_filter
    c = io.load(args.input, device=args.device)
    ground = progressive_morphological_filter(
        c, cell_size=args.cell_size, max_window_size=args.max_window,
        slope=args.slope, initial_distance=args.initial_distance,
        max_distance=args.max_distance)
    keep = ~ground if args.extract_negative else ground
    out = compact(dataclasses.replace(c, mask=c.mask & keep))
    io.save(args.output, out)
    print(f"[pmf] {int(c.count)} -> {int(out.count)} "
          f"({'non-ground' if args.extract_negative else 'ground'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
