"""CLI: generate a random cloud (counterpart of ``pcl_tpu/tools/generate.py``;
reference tools/generate.cpp). The points are numpy's draws from ``-seed``,
the JAX tool's, so both tools write the same file.

    python -m pcl_tpu_torch.tools.generate out.pcd -n 10000 -distribution normal [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate a synthetic cloud")
    ap.add_argument("output")
    ap.add_argument("-n", type=int, default=10000)
    ap.add_argument("-distribution", choices=["uniform", "normal"], default="uniform")
    ap.add_argument("-min", type=float, default=0.0)
    ap.add_argument("-max", type=float, default=1.0)
    ap.add_argument("-stddev", type=float, default=1.0)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy
    rng = np.random.default_rng(args.seed)
    if args.distribution == "uniform":
        pts = rng.uniform(args.min, args.max, size=(args.n, 3))
    else:
        pts = rng.normal(scale=args.stddev, size=(args.n, 3))
    io.save(args.output, from_numpy(pts.astype(np.float32), device=args.device))
    print(f"[generate] {args.n} {args.distribution} points -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
