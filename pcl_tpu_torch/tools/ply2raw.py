"""CLI: PLY mesh to a raw triangle soup (counterpart of
``pcl_tpu/tools/ply2raw.py``; reference: tools/ply2raw.cpp: one
'x1 y1 z1 x2 y2 z2 x3 y3 z3' line per face).

    python -m pcl_tpu_torch.tools.ply2raw in.ply out.raw [--device cpu]
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert a PLY mesh to a raw triangle file")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch.core.cloud import to_numpy
    from pcl_tpu_torch.io import ply
    cloud, faces = ply.load_mesh(args.input, device=args.device)
    if faces is None:
        raise SystemExit("ply2raw: input has no faces")
    xyz, _ = to_numpy(cloud)
    tris = xyz[np.asarray(faces)]            # [F, 3, 3]
    with open(args.output, "w") as f:
        for t in tris.reshape(len(tris), 9):
            f.write(" ".join(f"{v:g}" for v in t) + "\n")
    print(f"[ply2raw] wrote {args.output} ({len(tris)} triangles)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
