"""CLI: the VFH global descriptor (counterpart of
``pcl_tpu/tools/vfh_estimation.py``).

    python -m pcl_tpu_torch.tools.vfh_estimation in.pcd out.npy [-k 16] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Estimate the 308-bin VFH signature")
    ap.add_argument("input")
    ap.add_argument("output", help=".npy descriptor out")
    ap.add_argument("-k", type=int, default=16, help="normal neighborhood")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import features, io
    c = io.load(args.input, device=args.device)
    c = features.estimate_normals(c, k=args.k)
    vfh = features.estimate_vfh(c).cpu().numpy()
    np.save(args.output, vfh)
    print(f"[vfh_estimation] {int(c.count)} pts -> VFH[{vfh.shape[-1]}] "
          f"(sum {float(vfh.sum()):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
