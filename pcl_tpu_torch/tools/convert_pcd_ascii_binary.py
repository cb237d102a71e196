"""CLI: re-encode a PCD as ascii, binary or binary_compressed (counterpart of
``pcl_tpu/tools/convert_pcd_ascii_binary.py``; reference:
tools/convert_pcd_ascii_binary.cpp, argv[3] in {0, 1, 2}).

    python -m pcl_tpu_torch.tools.convert_pcd_ascii_binary in.pcd out.pcd 0|1|2 [--device cpu]
"""
import argparse
import sys

_MODES = {"0": "ascii", "1": "binary", "2": "binary_compressed",
          "ascii": "ascii", "binary": "binary",
          "binary_compressed": "binary_compressed"}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert PCD between ascii(0)/binary(1)/binary_compressed(2)")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("mode", choices=sorted(_MODES),
                    help="0=ascii 1=binary 2=binary_compressed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    c = io.load_pcd(args.input, device=args.device)
    io.save_pcd(args.output, c, data=_MODES[args.mode])
    print(f"[convert_pcd_ascii_binary] wrote {args.output} "
          f"({_MODES[args.mode]}, {int(c.count)} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
