"""CLI: print a PLY header (counterpart of ``pcl_tpu/tools/plyheader.py``;
reference: tools/plyheader.cpp). Reads the file's bytes only: no cloud, no
device.

    python -m pcl_tpu_torch.tools.plyheader in.ply
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dump the header of a PLY file")
    ap.add_argument("input")
    args = ap.parse_args(argv)
    with open(args.input, "rb") as f:
        for line in f:
            print(line.decode("ascii", "replace").rstrip())
            if line.strip() == b"end_header":
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
