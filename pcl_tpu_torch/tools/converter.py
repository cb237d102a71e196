"""CLI: universal format converter with an explicit output encoding
(counterpart of ``pcl_tpu/tools/converter.py``; reference: tools/converter.cpp:
pcd, ply, vtk, obj or ifs in; pcd or ply out, -f ascii|binary|binary_compressed).

    python -m pcl_tpu_torch.tools.converter in.ply out.pcd [-f binary] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Universal cloud format converter")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-f", "--format", default="binary",
                    choices=["ascii", "binary", "binary_compressed"],
                    help="output encoding (binary_compressed: PCD only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    c = io.load(args.input, device=args.device)
    out = args.output.lower()
    if out.endswith(".pcd"):
        io.save(args.output, c, data=args.format)
    elif out.endswith(".ply"):
        io.save(args.output, c, binary=args.format != "ascii")
    else:
        io.save(args.output, c)
    print(f"[converter] {args.input} -> {args.output} "
          f"[{args.format}] ({int(c.count)} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
