"""CLI: Euclidean cluster extraction (counterpart of
``pcl_tpu/tools/cluster_extraction.py``; reference:
tools/cluster_extraction.cpp). With ``--write`` each kept cluster goes to
``<prefix><i>.pcd``, as in the JAX tool.

    python -m pcl_tpu_torch.tools.cluster_extraction in.pcd [-tolerance 0.02] [-min_size 100] [-max_size N] [-prefix cluster_] [--write] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Extract euclidean clusters")
    ap.add_argument("input")
    ap.add_argument("-tolerance", type=float, default=0.02)
    ap.add_argument("-min_size", type=int, default=100)
    ap.add_argument("-max_size", type=int, default=1 << 30)
    ap.add_argument("-prefix", default="cluster_", help="output PCD prefix")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pcl_tpu_torch import io, segmentation
    c = io.load(args.input, device=args.device)
    labels, n = segmentation.euclidean_clusters(
        c, args.tolerance, min_cluster_size=args.min_size,
        max_cluster_size=args.max_size)
    labels = labels.cpu().numpy()
    kept = sorted(set(labels[labels >= 0].tolist()))
    print(f"[cluster_extraction] {len(kept)} clusters (of {int(n)} components)")
    for i, lab in enumerate(kept):
        sel = labels == lab
        print(f"  cluster {i}: {sel.sum()} points")
        if args.write:
            io.save(f"{args.prefix}{i}.pcd",
                    c.with_mask(torch.from_numpy(sel).to(c.mask.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
