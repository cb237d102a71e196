"""CLI: bilateral upsampling of organized RGB-D depth (counterpart of
``pcl_tpu/tools/bilateral_upsampling.py``; reference:
tools/bilateral_upsampling.cpp). Without an ``rgb`` field the guide is the
depth's own grey image, as in the JAX tool.

    python -m pcl_tpu_torch.tools.bilateral_upsampling in.pcd out.pcd [-window 5] [-sigma_color 15.0] [-sigma_depth 0.5] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Upsample organized cloud depth")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-window", type=int, default=5)
    ap.add_argument("-sigma_color", type=float, default=15.0)
    ap.add_argument("-sigma_depth", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import dataclasses
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.surface.processing import bilateral_upsampling
    c = io.load(args.input, device=args.device)
    if c.height <= 1:
        raise SystemExit("bilateral_upsampling requires an organized cloud")
    H, W = c.height, c.width
    z = c.xyz[:, 2].reshape(H, W)
    if "rgb" in c.attrs:
        rgb = c.attrs["rgb"].reshape(H, W, 3)
    else:
        g = torch.where(z > 0, z / torch.clamp(torch.max(z), min=1e-9), 0.0)
        rgb = torch.stack([g, g, g], -1)
    z_new = bilateral_upsampling(z, rgb, window=args.window,
                                 sigma_color=args.sigma_color,
                                 sigma_depth=args.sigma_depth)
    scale = (z_new / torch.where(z != 0, z, 1.0)).reshape(-1)
    out = dataclasses.replace(c, xyz=c.xyz * scale[:, None],
                              mask=c.mask | (z_new.reshape(-1) > 0))
    io.save(args.output, out)
    print(f"[bilateral_upsampling] window {args.window}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
