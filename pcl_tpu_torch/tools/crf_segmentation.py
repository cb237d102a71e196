"""CLI: refine a labelled cloud's labels with a dense CRF (counterpart of
``pcl_tpu/tools/crf_segmentation.py``; PCL's tools/crf_segmentation.cpp).

    python -m pcl_tpu_torch.tools.crf_segmentation in.pcd out.pcd -iters 10 -sxyz 0.05

The input needs a ``label`` field; with ``rgb`` a bilateral kernel at four
times ``-sxyz`` joins the Gaussian one.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Refine per-point labels with a fully-connected CRF")
    ap.add_argument("input", help="PCD with a 'label' attr (optionally 'rgb')")
    ap.add_argument("output")
    ap.add_argument("-iters", type=int, default=10)
    ap.add_argument("-sxyz", type=float, default=0.05,
                    help="Gaussian smoothness stddev (meters)")
    ap.add_argument("-srgb", type=float, default=0.1,
                    help="bilateral color stddev (0..1 units)")
    ap.add_argument("-unary-confidence", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import to_numpy
    from pcl_tpu_torch.ml.densecrf import DenseCRF
    c = io.load(args.input, device=args.device)
    xyz, attrs = to_numpy(c)
    if "label" not in attrs:
        raise SystemExit("crf_segmentation: input needs a 'label' attr")
    labels = attrs["label"].astype(np.int32).reshape(-1)
    n = len(xyz)
    n_classes = int(labels.max()) + 1
    # the unary energy of the initial labels (PCL's setUnaryEnergyFromAnnotations)
    p = (1.0 - args.unary_confidence) / max(n_classes - 1, 1)
    unary = np.full((n, n_classes), -np.log(p), np.float32)
    unary[np.arange(n), labels] = -np.log(args.unary_confidence)
    crf = DenseCRF(n, n_classes, device=args.device)
    crf.set_unary_energy(unary)
    crf.add_pairwise_gaussian(xyz, args.sxyz)
    if "rgb" in attrs:
        crf.add_pairwise_bilateral(xyz, attrs["rgb"], args.sxyz * 4, args.srgb)
    new_labels = np.argmax(crf.inference(args.iters), axis=1).astype(np.int32)
    changed = int((new_labels != labels).sum())
    lab = torch.zeros(c.capacity, dtype=torch.int32, device=c.xyz.device)
    lab[: len(new_labels)] = torch.as_tensor(new_labels, device=c.xyz.device)
    io.save(args.output, c.with_attrs(label=lab))
    print(f"[crf_segmentation] {n} points, {n_classes} classes, "
          f"{changed} labels changed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
