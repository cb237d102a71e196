"""CLI: cloud-to-cloud error statistics (counterpart of
``pcl_tpu/tools/compute_cloud_error.py``): each source point against its
nearest target point (the exact 1-NN, kernel B1 on the card) or the target
point of the same index.

    python -m pcl_tpu_torch.tools.compute_cloud_error source.pcd target.pcd
        [-correspondence nn|index] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Nearest-neighbor error statistics")
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("-correspondence", default="nn", choices=["nn", "index"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import math

    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.search import bruteforce
    a = io.load(args.source, device=args.device)
    b = io.load(args.target, device=args.device)
    if args.correspondence == "nn":
        _, d2 = bruteforce.nn1(b.xyz, b.mask, a.xyz)
    else:
        d2 = torch.sum((a.xyz - b.xyz) ** 2, dim=-1)
    d2 = torch.where(a.mask, d2, math.nan).cpu().numpy()
    d = np.sqrt(d2[np.isfinite(d2)])
    print(f"[compute_cloud_error] n={len(d)} rmse={np.sqrt((d**2).mean()):.6f} "
          f"mean={d.mean():.6f} median={np.median(d):.6f} max={d.max():.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
