"""CLI: NDT registration (counterpart of ``pcl_tpu/tools/ndt3d.py``).

    python -m pcl_tpu_torch.tools.ndt3d source.pcd target.pcd [-o aligned.pcd]
        [-r RESOLUTION] [--iters N] [--step S] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Align two clouds with 3D NDT")
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("-o", "--output")
    ap.add_argument("-r", "--resolution", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=35)
    ap.add_argument("--step", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.transforms import transform_cloud
    from pcl_tpu_torch.registration import ndt
    src = io.load(args.source, device=args.device)
    tgt = io.load(args.target, device=args.device)
    res = ndt(src, tgt, resolution=args.resolution,
              max_iterations=args.iters, step_size=args.step)
    np.set_printoptions(precision=6, suppress=True)
    print(f"[ndt3d] converged={bool(res.converged)} iters={int(res.iterations)}"
          f" score={float(res.score):.4f}")
    print(res.transform.cpu().numpy())
    if args.output:
        io.save(args.output, transform_cloud(res.transform, src))
    return 0


if __name__ == "__main__":
    sys.exit(main())
