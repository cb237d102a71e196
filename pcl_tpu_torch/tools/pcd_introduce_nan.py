"""CLI: invalidate random points with NaN, for robustness tests (counterpart
of ``pcl_tpu/tools/pcd_introduce_nan.py``; reference:
tools/pcd_introduce_nan.cpp). The points are drawn by numpy's
``default_rng(seed)`` on the host, as the JAX tool draws them: the same
points go.

    python -m pcl_tpu_torch.tools.pcd_introduce_nan in.pcd out.pcd [-fraction 0.1] [-seed 0] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Randomly invalidate points with NaN")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-fraction", type=float, default=0.1)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import dataclasses
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.io import pcd as pcd_io
    c = io.load(args.input, keep_invalid=True, device=args.device)
    rng = np.random.default_rng(args.seed)
    kill = rng.random(c.capacity) < args.fraction
    xyz = c.xyz.cpu().numpy().copy()
    xyz[kill] = np.nan
    dev = c.xyz.device
    out = dataclasses.replace(c, xyz=torch.from_numpy(xyz).to(dev),
                              mask=c.mask & torch.from_numpy(~kill).to(dev))
    pcd_io.save(args.output, out, data="ascii", compact=False)
    print(f"[pcd_introduce_nan] invalidated {int(kill.sum())} of {c.capacity}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
