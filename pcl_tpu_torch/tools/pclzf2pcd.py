"""CLI: re-encode a ``binary_compressed`` (LZF) PCD as plain binary
(counterpart of ``pcl_tpu/tools/pclzf2pcd.py``; reference: tools/pclzf2pcd.cpp).

    python -m pcl_tpu_torch.tools.pclzf2pcd in.pcd out.pcd [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Re-encode a binary_compressed PCD as plain binary")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch.io import pcd as pcd_io
    c = pcd_io.load(args.input, device=args.device)
    pcd_io.save(args.output, c, data="binary")
    print(f"[pclzf2pcd] {int(c.count)} points re-encoded as binary")
    return 0


if __name__ == "__main__":
    sys.exit(main())
