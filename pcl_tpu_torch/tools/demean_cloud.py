"""CLI: subtract the centroid (counterpart of ``pcl_tpu/tools/demean_cloud.py``;
reference: tools/demean_cloud.cpp).

    python -m pcl_tpu_torch.tools.demean_cloud in.pcd out.pcd [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Demean a cloud")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import dataclasses
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.geometry import centroid
    c = io.load(args.input, device=args.device)
    mu = centroid(c.xyz, c.mask)
    out = dataclasses.replace(c, xyz=torch.where(c.mask[:, None], c.xyz - mu, c.xyz))
    io.save(args.output, out)
    print(f"[demean_cloud] centroid {[round(float(x), 5) for x in mu]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
