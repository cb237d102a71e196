"""CLI: symmetric Hausdorff distance between two clouds (counterpart of
``pcl_tpu/tools/compute_hausdorff.py``); each direction is one exact 1-NN
sweep, kernel B1 on the card.

    python -m pcl_tpu_torch.tools.compute_hausdorff a.pcd b.pcd [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Hausdorff distance between clouds")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.geometry import hausdorff
    ca = io.load(args.a, device=args.device)
    cb = io.load(args.b, device=args.device)
    h = float(hausdorff(ca.xyz, ca.mask, cb.xyz, cb.mask))
    print(f"[compute_hausdorff] {h:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
