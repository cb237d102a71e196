"""CLI: spin-image descriptors (counterpart of
``pcl_tpu/tools/spin_estimation.py``).

    python -m pcl_tpu_torch.tools.spin_estimation in.pcd out.npy [-radius 0.05] [-k 16] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Per-point spin images")
    ap.add_argument("input")
    ap.add_argument("output", help=".npy [N,bins] out")
    ap.add_argument("-radius", type=float, default=0.05)
    ap.add_argument("-k", type=int, default=16, help="normal neighborhood")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import features, io
    c = io.load(args.input, device=args.device)
    c = features.estimate_normals(c, k=args.k)
    si = features.spin_images(c, radius=args.radius).cpu().numpy()
    np.save(args.output, si)
    print(f"[spin_estimation] {int(c.count)} pts -> spin images {si.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
