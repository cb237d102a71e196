"""CLI: headless image viewer (counterpart of ``pcl_tpu/tools/image_viewer.py``;
reference: tools/image_viewer.cpp, an interactive ImageViewer): writes the RGB
and/or depth channels of an organized cloud as PNGs.

    python -m pcl_tpu_torch.tools.image_viewer organized.pcd [-rgb rgb.png] [-depth depth.png] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Snapshot an organized cloud as images")
    ap.add_argument("input", help="organized PCD")
    ap.add_argument("-rgb", help="write the color channel PNG here")
    ap.add_argument("-depth", help="write the depth channel (16-bit mm) PNG here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.io.png import save_depth_png, save_rgb_png
    c = io.load(args.input, device=args.device)
    if c.height <= 1:
        raise SystemExit("image_viewer: input is not organized")
    H, W = c.height, c.width
    wrote = []
    if args.rgb:
        if "rgb" not in c.attrs:
            raise SystemExit("image_viewer: no rgb attr")
        save_rgb_png(args.rgb, c.attrs["rgb"].cpu().numpy().reshape(H, W, 3))
        wrote.append(args.rgb)
    if args.depth:
        z = c.xyz[:, 2].cpu().numpy().reshape(H, W)
        z = np.where(c.mask.cpu().numpy().reshape(H, W), z, 0.0)
        save_depth_png(args.depth, z)
        wrote.append(args.depth)
    print(f"[image_viewer] {W}x{H} organized cloud"
          + (f" -> {', '.join(wrote)}" if wrote else " (no outputs requested)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
