"""CLI: a morphological filter of z on a LiDAR ground grid (counterpart of
``pcl_tpu/tools/morph.py``; reference: tools/morph.cpp). Runs the filter at
its default window, as the JAX tool does (ROADMAP C38).

    python -m pcl_tpu_torch.tools.morph in.pcd out.pcd [-operator open] [-resolution 1.0] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Morphological dilate/erode/open/close")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-operator", choices=["dilate", "erode", "open", "close"],
                    default="open")
    ap.add_argument("-resolution", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.filters.morphological import morphological_filter
    c = io.load(args.input, device=args.device)
    z = morphological_filter(c, resolution=args.resolution, operator=args.operator)
    xyz = c.xyz.clone()
    xyz[:, 2] = z
    io.save(args.output, c.with_xyz(xyz))
    print(f"[morph] {args.operator} at resolution {args.resolution}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
