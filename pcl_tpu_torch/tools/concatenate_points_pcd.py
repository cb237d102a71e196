"""CLI: concatenate the points of several clouds into one (counterpart of
``pcl_tpu/tools/concatenate_points_pcd.py``; reference:
tools/concatenate_points_pcd.cpp).

    python -m pcl_tpu_torch.tools.concatenate_points_pcd in1.pcd in2.pcd [...] out.pcd [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Concatenate clouds (points union)")
    ap.add_argument("inputs", nargs="+", help="input clouds, last arg is the output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.inputs) < 3:
        print("usage: concatenate_points_pcd in1 in2 [...] out", file=sys.stderr)
        return 1
    *ins, out_path = args.inputs

    import functools
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import concat

    clouds = [io.load(p, device=args.device) for p in ins]
    out = functools.reduce(concat, clouds)
    io.save(out_path, out)
    print(f"[concatenate] {len(ins)} clouds -> {int(out.count)} points -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
