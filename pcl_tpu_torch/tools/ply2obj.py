"""CLI: PLY mesh -> Wavefront OBJ (counterpart of ``pcl_tpu/tools/ply2obj.py``;
reference: tools/ply2obj.cpp). The OBJ text is written here, line for line
as the JAX tool writes it (``io`` has no OBJ writer, ROADMAP C86).

    python -m pcl_tpu_torch.tools.ply2obj in.ply out.obj [--device cpu]
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert a PLY mesh to OBJ")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch.core.cloud import ATTR_NORMAL, to_numpy
    from pcl_tpu_torch.io import ply
    cloud, faces = ply.load_mesh(args.input, device=args.device)
    xyz, attrs = to_numpy(cloud)
    nrm = attrs.get(ATTR_NORMAL)
    with open(args.output, "w") as f:
        f.write("# converted by pcl_tpu ply2obj\n")
        for p in xyz:
            f.write(f"v {p[0]:g} {p[1]:g} {p[2]:g}\n")
        if nrm is not None:
            for n in nrm:
                f.write(f"vn {n[0]:g} {n[1]:g} {n[2]:g}\n")
        if faces is not None:
            for tri in np.asarray(faces):
                if nrm is not None:
                    f.write("f " + " ".join(f"{i+1}//{i+1}" for i in tri) + "\n")
                else:
                    f.write("f " + " ".join(str(i + 1) for i in tri) + "\n")
    nf = 0 if faces is None else len(faces)
    print(f"[ply2obj] wrote {args.output} ({len(xyz)} vertices, {nf} faces)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
