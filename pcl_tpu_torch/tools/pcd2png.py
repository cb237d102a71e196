"""CLI: organized PCD -> PNG image (counterpart of ``pcl_tpu/tools/pcd2png.py``;
reference: tools/pcd2png.cpp): ``z`` as a 16-bit depth PNG (millimetres by
default), ``rgb`` as an 8-bit colour PNG, ``intensity`` stretched to 8 bits.

    python -m pcl_tpu_torch.tools.pcd2png in.pcd out.png [-field z|rgb|intensity] [-scale 1000] [--device cpu]

The JAX tool's intensity field calls ``ndarray.ptp``, which numpy 2 removed
(it raises ``AttributeError`` there); the port takes ``np.ptp``, the same
value (ROADMAP C93).
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Render an organized cloud to PNG")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-field", choices=["z", "rgb", "intensity"], default="z")
    ap.add_argument("-scale", type=float, default=1000.0, help="depth mm scale")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np

    from pcl_tpu_torch import io
    from pcl_tpu_torch.io.png import save_depth_png, save_png, save_rgb_png
    c = io.load(args.input, device=args.device)
    if c.height <= 1:
        raise SystemExit("pcd2png requires an organized cloud")
    H, W = c.height, c.width
    if args.field == "z":
        z = c.xyz[:, 2].cpu().numpy().reshape(H, W)
        save_depth_png(args.output, z, scale=args.scale)
    elif args.field == "rgb":
        rgb = c.attrs["rgb"].cpu().numpy().reshape(H, W, 3)
        save_rgb_png(args.output, rgb)
    else:
        i = c.attrs["intensity"].cpu().numpy().reshape(H, W)
        i = (255 * (i - i.min()) / max(np.ptp(i), 1e-9)).astype(np.uint8)
        save_png(args.output, i)
    print(f"[pcd2png] {W}x{H} {args.field} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
