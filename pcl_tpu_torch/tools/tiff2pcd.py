"""CLI: depth(+RGB) TIFF frames -> organized PCDs (counterpart of
``pcl_tpu/tools/tiff2pcd.py``; reference: tools/tiff2pcd.cpp — pairs depth
and RGB TIFF directories and writes one organized cloud per frame; depth in
16-bit millimeters, the principal point at ``(W/2, H/2)``).

    python -m pcl_tpu_torch.tools.tiff2pcd depth_dir out_dir [-rgb_dir DIR] [-focal 525] [-scale 1000] [--device cpu]
"""
import argparse
import glob
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert TIFF depth frames to PCDs")
    ap.add_argument("depth_dir", help="directory of 16-bit depth TIFFs (mm)")
    ap.add_argument("out_dir")
    ap.add_argument("-rgb_dir", help="optional directory of matching RGB TIFFs")
    ap.add_argument("-focal", type=float, default=525.0)
    ap.add_argument("-scale", type=float, default=1000.0,
                    help="depth units per meter")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import _device, make_cloud
    from pcl_tpu_torch.fusion import Intrinsics, depth_to_vertex_map
    from pcl_tpu_torch.io.tiff import load_tiff
    dev = _device(args.device)
    depth_paths = sorted(glob.glob(os.path.join(args.depth_dir, "*.tif"))
                         + glob.glob(os.path.join(args.depth_dir, "*.tiff")))
    rgb_paths = []
    if args.rgb_dir:
        rgb_paths = sorted(glob.glob(os.path.join(args.rgb_dir, "*.tif"))
                           + glob.glob(os.path.join(args.rgb_dir, "*.tiff")))
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for i, dp in enumerate(depth_paths):
        depth = load_tiff(dp).astype(np.float32) / args.scale
        H, W = depth.shape
        intr = Intrinsics(args.focal, args.focal, W / 2.0, H / 2.0)
        vm = depth_to_vertex_map(torch.as_tensor(depth, device=dev), intr)
        c = make_cloud(vm.reshape(-1, 3), (depth > 0).reshape(-1), width=W, height=H,
                       device=dev)
        if i < len(rgb_paths):
            rgb = load_tiff(rgb_paths[i]).astype(np.float32) / 255.0
            c = c.with_attrs(rgb=torch.as_tensor(rgb.reshape(-1, 3), device=dev))
        out = os.path.join(args.out_dir, f"frame_{i:06d}.pcd")
        io.save(out, c)
        print(f"[tiff2pcd] {dp} -> {out} ({int(c.count)} points)")
        n += 1
    print(f"[tiff2pcd] {n} frames converted")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
