"""CLI: octree occupancy view (counterpart of ``pcl_tpu/tools/octree_viewer.py``;
reference: tools/octree_viewer.cpp): the leaf centroids of the cloud's linear
octree (one call of kernel B2) exported as an interactive HTML view.

    python -m pcl_tpu_torch.tools.octree_viewer in.pcd out.html [-resolution 0.05] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export an octree view as HTML")
    ap.add_argument("input")
    ap.add_argument("output", help=".html out")
    ap.add_argument("-resolution", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.octree import linear as oct
    from pcl_tpu_torch.visualization.export import cloud_to_html
    c = io.load(args.input, device=args.device)
    tree = oct.build(c.xyz, c.mask, resolution=args.resolution)
    cent, cnt, n_leaves = oct.leaf_centroids(tree, c.xyz)
    cent = cent.cpu().numpy()[: int(n_leaves)]
    cloud_to_html(args.output, from_numpy(cent.astype(np.float32), device=args.device))
    print(f"[octree_viewer] {int(c.count)} pts -> {len(cent)} leaves "
          f"@ {args.resolution} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
