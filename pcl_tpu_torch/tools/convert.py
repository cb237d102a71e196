"""CLI: format conversion by extension (counterpart of
``pcl_tpu/tools/convert.py``; reference: tools/pcd2ply.cpp, ply2pcd.cpp,
obj2pcd...).

    python -m pcl_tpu_torch.tools.convert in.obj out.pcd [--ascii] [--device cpu]

``.pcd``, ``.ply``, ``.xyz``/``.txt``, ``.obj``, ``.ifs`` and ``.vtk`` are
read; the same but ``.obj`` are written (``io.save`` of an ``.obj`` raises
in both packages, ROADMAP C86).
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert between cloud formats (by extension)")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--ascii", action="store_true", help="write ASCII where supported")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    c = io.load(args.input, device=args.device)
    kw = {}
    if args.output.lower().endswith(".ply"):
        kw["binary"] = not args.ascii
    elif args.output.lower().endswith(".pcd"):
        kw["data"] = "ascii" if args.ascii else "binary_compressed"
    io.save(args.output, c, **kw)
    print(f"[convert] {args.input} -> {args.output} ({int(c.count)} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
