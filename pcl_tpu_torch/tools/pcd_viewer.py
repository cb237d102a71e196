"""CLI: headless cloud viewer (counterpart of ``pcl_tpu/tools/pcd_viewer.py``;
reference: tools/pcd_viewer.cpp, the interactive PCLVisualizer CLI): prints
each file's count, bounding box and attributes, and exports the clouds,
concatenated, as a self-contained HTML viewer and/or an ASCII render.

    python -m pcl_tpu_torch.tools.pcd_viewer a.pcd [b.pcd ...] [-html out.html] [-ascii] [-axis 2] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="View PCD files (headless)")
    ap.add_argument("inputs", nargs="+", help="cloud files (concatenated)")
    ap.add_argument("-html", help="write an interactive HTML viewer here")
    ap.add_argument("-ascii", action="store_true",
                    help="print an ASCII orthographic render")
    ap.add_argument("-axis", type=int, default=2, choices=[0, 1, 2],
                    help="ASCII projection axis")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy, to_numpy
    pts, cols = [], []
    for p in args.inputs:
        c = io.load(p, device=args.device)
        xyz, attrs = to_numpy(c, compact=True)
        pts.append(xyz)
        cols.append(attrs.get("rgb"))
        mn, mx = xyz.min(0), xyz.max(0)
        print(f"[pcd_viewer] {p}: {len(xyz)} points, "
              f"bbox [{mn[0]:.3g},{mn[1]:.3g},{mn[2]:.3g}] .. "
              f"[{mx[0]:.3g},{mx[1]:.3g},{mx[2]:.3g}], "
              f"attrs: {sorted(attrs)}")
    merged = from_numpy(np.concatenate(pts).astype(np.float32), device=args.device)
    if all(cc is not None for cc in cols):
        merged = merged.with_attrs(rgb=torch.as_tensor(
            np.concatenate(cols).astype(np.float32), device=merged.xyz.device))
    if args.html:
        from pcl_tpu_torch.visualization.export import cloud_to_html
        cloud_to_html(args.html, merged, title=" + ".join(args.inputs))
        print(f"[pcd_viewer] wrote {args.html}")
    if args.ascii:
        from pcl_tpu_torch.visualization.export import render_ascii
        print(render_ascii(merged, axis=args.axis))
    return 0


if __name__ == "__main__":
    sys.exit(main())
