"""CLI: voxel-grid downsampling (counterpart of ``pcl_tpu/tools/voxel_grid.py``).

    python -m pcl_tpu_torch.tools.voxel_grid in.pcd out.pcd -leaf 0.2 [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Downsample a cloud with a voxel grid")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-leaf", type=float, default=0.01)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.filters import voxel_downsample
    c = io.load(args.input, device=args.device)
    out = voxel_downsample(c, args.leaf)
    print(f"[voxel_grid] {int(c.count)} -> {int(out.count)} points (leaf {args.leaf})")
    io.save(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
