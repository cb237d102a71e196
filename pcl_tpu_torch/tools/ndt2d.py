"""CLI: 2-D NDT scan matching (counterpart of ``pcl_tpu/tools/ndt2d.py``).

    python -m pcl_tpu_torch.tools.ndt2d source.pcd target.pcd [out.pcd]
        [-grid CELL] [-iters N] [--device cpu]
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="Planar NDT alignment of two scans")
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("-grid", type=float, default=1.0, help="NDT cell size")
    ap.add_argument("-iters", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.registration import ndt_2d

    src = io.load(args.source, device=args.device)
    tgt = io.load(args.target, device=args.device)
    res = ndt_2d(src, tgt, grid_extent=args.grid, max_iterations=args.iters)
    tx, ty, th = res.params.cpu().numpy()
    print(f"[ndt2d] converged={bool(res.converged)} iters={int(res.iterations)} "
          f"score={float(res.score):.4g}")
    print(f"[ndt2d] tx={tx:.6f} ty={ty:.6f} theta={th:.6f}")
    print(np.array2string(res.transform.cpu().numpy(), precision=6, suppress_small=True))
    if args.output:
        io.save(args.output, src.with_xyz(transform_points(res.transform, src.xyz)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
