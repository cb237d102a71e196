"""CLI: label a cloud's points with a trained unary classifier (counterpart
of ``pcl_tpu/tools/unary_classifier_segment.py``; reference:
tools/unary_classifier_segment.cpp).

    python -m pcl_tpu_torch.tools.unary_classifier_segment in.pcd codebook.npz out.pcd [-k 16] [-fpfh_k 16] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Per-point classification")
    ap.add_argument("input")
    ap.add_argument("codebook", help=".npz from train")
    ap.add_argument("output", help="PCD with label attr")
    ap.add_argument("-k", type=int, default=16)
    ap.add_argument("-fpfh_k", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import collections
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.features.fpfh import estimate_fpfh
    from pcl_tpu_torch.features.normals import estimate_normals
    from pcl_tpu_torch.segmentation.advanced import UnaryClassifier
    c = io.load(args.input, device=args.device)
    cn = estimate_normals(c, k=args.k)
    f = estimate_fpfh(cn, k=args.fpfh_k).cpu().numpy()
    z = np.load(args.codebook)
    clf = UnaryClassifier()
    clf.centroids = z["centroids"]
    clf.class_of = z["class_of"]
    labels = clf.segment(f)
    out = c.with_attrs(label=torch.from_numpy(labels.astype(np.int32)).to(c.xyz.device))
    io.save(args.output, out)
    counts = collections.Counter(labels[c.mask.cpu().numpy()].tolist())
    print(f"[unary_classifier_segment] {dict(counts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
