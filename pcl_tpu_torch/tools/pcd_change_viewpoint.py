"""CLI: rewrite the VIEWPOINT of a PCD (counterpart of
``pcl_tpu/tools/pcd_change_viewpoint.py``; reference:
tools/pcd_change_viewpoint.cpp).

    python -m pcl_tpu_torch.tools.pcd_change_viewpoint in.pcd out.pcd tx ty tz qw qx qy qz [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Set the PCD VIEWPOINT header")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("viewpoint", nargs=7, type=float,
                    help="tx ty tz qw qx qy qz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch.io import pcd as pcd_io
    c = pcd_io.load(args.input, device=args.device)
    pcd_io.save(args.output, c, viewpoint=np.asarray(args.viewpoint, np.float32))
    print(f"[pcd_change_viewpoint] -> {args.viewpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
