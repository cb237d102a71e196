"""CLI: occupancy of ObjRecRANSAC's model pair-feature hash table
(counterpart of ``pcl_tpu/tools/obj_rec_ransac_hash_table.py``; reference
tools/obj_rec_ransac_hash_table.cpp): prints the cells' occupancy and can
save the 3-D angle histogram.

    python -m pcl_tpu_torch.tools.obj_rec_ransac_hash_table model.pcd -pairs 2048 -bins 16 [-output h.npy]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Model pair-feature hash table stats")
    ap.add_argument("model")
    ap.add_argument("-pair_width", type=float, default=0.15)
    ap.add_argument("-pairs", type=int, default=2048)
    ap.add_argument("-bins", type=int, default=16)
    ap.add_argument("-output", help="write the histogram as .npy here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.recognition.orr import pair_feature_hash_table
    from pcl_tpu_torch.tools.obj_rec_ransac_accepted_hypotheses import with_normals
    c = with_normals(io.load(args.model, device=args.device))
    hist, n_valid = pair_feature_hash_table(c, args.pair_width, n_pairs=args.pairs,
                                            n_bins=args.bins)
    occ = int((hist > 0).sum())
    total = args.bins ** 3
    print(f"[obj_rec_ransac_hash_table] {n_valid} pairs -> "
          f"{occ}/{total} cells occupied "
          f"(max cell {int(hist.max())}, mean occupied "
          f"{hist[hist > 0].mean() if occ else 0:.2f})")
    if args.output:
        np.save(args.output, hist)
    return 0


if __name__ == "__main__":
    sys.exit(main())
