"""CLI: headless registration visualizer (counterpart of
``pcl_tpu/tools/registration_visualizer.py``; reference:
tools/registration_visualizer.cpp, a live display of intermediate ICP
correspondences): runs ICP in stages, writing a top-down SVG of source and
target after each stage and an MSE-against-iteration plot. With the default
infinite ``-dist`` ICP takes the brute backend (kernel B1 once an
iteration).

    python -m pcl_tpu_torch.tools.registration_visualizer src.pcd tgt.pcd out_dir [-iters 20] [-stages 5] [-dist inf] [--device cpu]
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Visualize ICP progress (headless)")
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("out_dir")
    ap.add_argument("-iters", type=int, default=20)
    ap.add_argument("-stages", type=int, default=5,
                    help="number of SVG snapshots across the run")
    ap.add_argument("-dist", type=float, default=float("inf"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.registration.icp import icp
    from pcl_tpu_torch.visualization.plotter import plot_xy_svg
    src = io.load(args.source, device=args.device)
    tgt = io.load(args.target, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    per_stage = max(args.iters // args.stages, 1)
    T = torch.eye(4, device=src.xyz.device)
    mses = []
    txy = tgt.xyz[tgt.mask].cpu().numpy()
    for s in range(args.stages):
        res = icp(src, tgt, init_transform=T, max_corr_dist=args.dist,
                  max_iterations=per_stage, transformation_eps=0.0,
                  abs_mse_eps=0.0, rel_mse_eps=0.0)
        T = res.transform
        mses.append(float(res.fitness))
        sxy = transform_points(T, src.xyz)[src.mask].cpu().numpy()
        frame = os.path.join(args.out_dir, f"stage_{s:03d}.svg")
        plot_xy_svg(frame,
                    [(txy[:, 0], txy[:, 1], "target"),
                     (sxy[:, 0], sxy[:, 1], "source")],
                    title=f"iter {(s + 1) * per_stage}  mse={mses[-1]:.4g}")
        print(f"[registration_visualizer] {frame} mse={mses[-1]:.6g}")
    plot_xy_svg(os.path.join(args.out_dir, "mse.svg"),
                [(np.arange(1, len(mses) + 1, dtype=float) * per_stage,
                  np.asarray(mses), "mse")],
                title="ICP convergence")
    print(f"[registration_visualizer] {args.stages} stages -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
