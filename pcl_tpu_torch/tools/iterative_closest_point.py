"""CLI: minimal ICP alignment of two clouds (counterpart of
``pcl_tpu/tools/iterative_closest_point.py``): load, align, print the
transform and the fitness.

    python -m pcl_tpu_torch.tools.iterative_closest_point source.pcd target.pcd
        [out.pcd] [-iters N] [-dist D] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Align source onto target with ICP")
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("output", nargs="?", help="write aligned source here")
    ap.add_argument("-iters", type=int, default=50)
    ap.add_argument("-dist", type=float, default=float("inf"),
                    help="max correspondence distance")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.registration.icp import align
    src = io.load(args.source, device=args.device)
    tgt = io.load(args.target, device=args.device)
    aligned, res = align(src, tgt, max_corr_dist=args.dist, max_iterations=args.iters)
    np.set_printoptions(precision=6, suppress=True)
    print(f"[iterative_closest_point] converged={bool(res.converged)} "
          f"score={float(res.fitness):.6g} iters={int(res.iterations)}")
    print(res.transform.cpu().numpy())
    if args.output:
        io.save(args.output, aligned)
    return 0


if __name__ == "__main__":
    sys.exit(main())
