"""CLI: FPFH descriptors (counterpart of ``pcl_tpu/tools/fpfh_estimation.py``).

    python -m pcl_tpu_torch.tools.fpfh_estimation in.pcd out.pcd -k 16 -nk 16 [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Compute FPFH descriptors")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-k", type=int, default=16)
    ap.add_argument("-nk", type=int, default=16, help="normal-estimation k")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import features, io
    c = io.load(args.input, device=args.device)
    c = features.estimate_normals(c, k=args.nk)
    out = c.with_attrs(fpfh=features.estimate_fpfh(c, k=args.k))
    print(f"[fpfh_estimation] {int(out.count)} descriptors (33 bins)")
    io.save(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
