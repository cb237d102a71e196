"""CLI: normalize NaN spelling in ASCII PCDs (counterpart of
``pcl_tpu/tools/pcd_convert_NaN_nan.py``; reference:
tools/pcd_convert_NaN_nan.cpp: old writers emitted 'NaN', readers expect
'nan'). Rewrites the file's bytes only: no cloud, no device.

    python -m pcl_tpu_torch.tools.pcd_convert_NaN_nan in.pcd out.pcd
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Rewrite NaN -> nan in an ascii PCD")
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    with open(args.input, "rb") as f:
        data = f.read()
    out = data.replace(b"NaN", b"nan")
    with open(args.output, "wb") as f:
        f.write(out)
    print(f"[pcd_convert_NaN_nan] {data.count(b'NaN')} tokens rewritten")
    return 0


if __name__ == "__main__":
    sys.exit(main())
