"""CLI: ELCH loop closing over a scan chain (counterpart of
``pcl_tpu/tools/elch.py``, PCL's tools/elch.cpp): ICP of the last scan onto
the first, then the correction spread over the chain, each scan written moved
as ``<name><suffix><ext>``.

Usage: python -m pcl_tpu_torch.tools.elch scan0.pcd ... scanN.pcd [-dist 0.1]
         [-iter 50] [-suffix _out] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Close the loop of a scan chain and distribute the correction")
    ap.add_argument("inputs", nargs="+", help="scans in chain order (loop: last ~ first)")
    ap.add_argument("-dist", type=float, default=0.1, help="ICP max correspondence distance")
    ap.add_argument("-iter", type=int, default=50)
    ap.add_argument("-suffix", default="_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.registration.graph import elch_distribute
    from pcl_tpu_torch.registration.icp import icp

    clouds = [io.load(p, device=args.device) for p in args.inputs]
    V = len(clouds)
    if V < 3:
        print("[elch] need at least 3 scans", file=sys.stderr)
        return 1

    # align the loop's end (the last scan) onto its start (the first)
    res = icp(clouds[-1], clouds[0], max_corr_dist=args.dist, max_iterations=args.iter)
    print(f"[elch] loop ICP converged={bool(res.converged)} fitness={float(res.fitness):.4g}")

    dev = clouds[0].xyz.device
    poses0 = torch.eye(4, dtype=torch.float32, device=dev).repeat(V, 1, 1)
    poses = elch_distribute(poses0, res.transform)

    for i, (path, c) in enumerate(zip(args.inputs, clouds)):
        out = c.with_xyz(transform_points(poses[i], c.xyz))
        base, ext = os.path.splitext(path)
        io.save(base + args.suffix + (ext or ".pcd"), out)
    print(f"[elch] wrote {V} corrected scans")
    return 0


if __name__ == "__main__":
    sys.exit(main())
