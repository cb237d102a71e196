"""CLI: depth PNG -> organized cloud (counterpart of ``pcl_tpu/tools/png2pcd.py``;
reference: tools/png2pcd.cpp): a 16-bit depth PNG back-projected through
``fusion.depth_to_vertex_map``, the principal point at ``(W/2 - 0.5, H/2 -
0.5)`` unless given.

    python -m pcl_tpu_torch.tools.png2pcd depth.png out.pcd [-fx 525] [-fy 525] [-cx -1] [-cy -1] [-scale 1000] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Back-project a depth PNG to a cloud")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-fx", type=float, default=525.0)
    ap.add_argument("-fy", type=float, default=525.0)
    ap.add_argument("-cx", type=float, default=-1.0, help="-1 = W/2")
    ap.add_argument("-cy", type=float, default=-1.0, help="-1 = H/2")
    ap.add_argument("-scale", type=float, default=1000.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import Cloud, _device
    from pcl_tpu_torch.fusion import Intrinsics, depth_to_vertex_map
    from pcl_tpu_torch.io.png import load_depth_png
    d = load_depth_png(args.input, scale=args.scale)
    H, W = d.shape
    intr = Intrinsics(args.fx, args.fy,
                      args.cx if args.cx >= 0 else W / 2 - 0.5,
                      args.cy if args.cy >= 0 else H / 2 - 0.5)
    dev = _device(args.device)
    depth = torch.as_tensor(d, device=dev)
    xyz = depth_to_vertex_map(depth, intr).reshape(-1, 3)
    mask = (depth > 0).reshape(-1)
    io.save(args.output, Cloud(xyz=xyz, mask=mask, width=W, height=H))
    print(f"[png2pcd] {W}x{H} -> {int(mask.sum())} valid points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
