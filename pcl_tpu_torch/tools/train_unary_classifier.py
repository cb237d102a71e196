"""CLI: train the unary point classifier (counterpart of
``pcl_tpu/tools/train_unary_classifier.py``; reference:
tools/train_unary_classifier.cpp: k-means codebooks of FPFH features per
class).

    python -m pcl_tpu_torch.tools.train_unary_classifier class0.pcd class1.pcd ... -o codebook.npz [-clusters 8] [-k 16] [-fpfh_k 16] [--device cpu]

K-means draws its initial centroids: the JAX tool from ``PRNGKey(0)``, here a
generator seeded 0 on the device (ROADMAP C17, C61);
``main(init_indices=[...])`` takes each class's initial rows from the
caller instead.
"""
import argparse
import sys


def main(argv=None, init_indices=None):
    ap = argparse.ArgumentParser(description="Train a unary classifier")
    ap.add_argument("clouds", nargs="+", help="one PCD per class")
    ap.add_argument("-o", "--output", required=True, help=".npz codebook")
    ap.add_argument("-clusters", type=int, default=8)
    ap.add_argument("-k", type=int, default=16, help="normal neighborhood")
    ap.add_argument("-fpfh_k", type=int, default=16, help="FPFH neighborhood")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.features.fpfh import estimate_fpfh
    from pcl_tpu_torch.features.normals import estimate_normals
    from pcl_tpu_torch.segmentation.advanced import UnaryClassifier
    feats = []
    for path in args.clouds:
        c = io.load(path, device=args.device)
        c = estimate_normals(c, k=args.k)
        f = estimate_fpfh(c, k=args.fpfh_k).cpu().numpy()
        feats.append(f[c.mask.cpu().numpy()])
    dev = torch.device(args.device)
    gen = None if init_indices is not None else torch.Generator(device=dev).manual_seed(0)
    clf = UnaryClassifier().train(feats, clusters_per_class=args.clusters,
                                  init_indices=init_indices, generator=gen, device=dev)
    np.savez(args.output, centroids=clf.centroids, class_of=clf.class_of)
    print(f"[train_unary_classifier] {len(feats)} classes -> "
          f"{len(clf.centroids)} centroids")
    return 0


if __name__ == "__main__":
    sys.exit(main())
