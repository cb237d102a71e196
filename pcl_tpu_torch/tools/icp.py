"""CLI: pairwise ICP registration (counterpart of ``pcl_tpu/tools/icp.py``).

Usage: python -m pcl_tpu_torch.tools.icp source.pcd target.pcd [-o aligned.pcd]
         [--max-corr-dist D] [--iters N] [--variant point_to_point|point_to_plane]
         [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Align source onto target with ICP")
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("-o", "--output", help="write aligned source cloud here")
    ap.add_argument("--max-corr-dist", type=float, default=float("inf"))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--eps", type=float, default=1e-8)
    ap.add_argument("--variant", default="point_to_point",
                    choices=["point_to_point", "point_to_plane", "symmetric"])
    ap.add_argument("--reciprocal", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pcl_tpu_torch import io
    from pcl_tpu_torch.registration import align
    from pcl_tpu_torch.utils.timing import StopWatch

    src = io.load(args.source, device=args.device)
    tgt = io.load(args.target, device=args.device)
    print(f"[icp] source: {int(src.count)} pts  target: {int(tgt.count)} pts")

    sw = StopWatch()
    out, res = align(
        src, tgt,
        max_corr_dist=args.max_corr_dist,
        max_iterations=args.iters,
        transformation_eps=args.eps,
        variant=args.variant,
        reciprocal=args.reciprocal,
    )
    T = res.transform.cpu().numpy()            # waits for the device
    elapsed = sw.ms()
    print(f"[icp] converged={bool(res.converged)} iters={int(res.iterations)} "
          f"fitness={float(res.fitness):.3e} corr={int(res.num_correspondences)} "
          f"({elapsed:.1f} ms)")
    np.set_printoptions(precision=6, suppress=True)
    print(T)
    if args.output:
        io.save(args.output, out)
        print(f"[icp] wrote {args.output}")
    return 0 if bool(res.converged) else 1


if __name__ == "__main__":
    sys.exit(main())
