"""CLI: the ObjRecRANSAC scene octree's leaves (counterpart of
``pcl_tpu/tools/obj_rec_ransac_orr_octree.py``; reference:
tools/obj_rec_ransac_orr_octree.cpp): builds the linear octree at ``-leaf``,
prints the full leaves' statistics (the centroids are one call of kernel
B2) and optionally exports the leaf centroids as HTML.

    python -m pcl_tpu_torch.tools.obj_rec_ransac_orr_octree in.pcd [-leaf 0.05] [-html out.html] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="ORR octree build + leaf stats")
    ap.add_argument("input")
    ap.add_argument("-leaf", type=float, default=0.05, help="leaf size")
    ap.add_argument("-html", help="export leaf centroids as an HTML viewer")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.octree import linear
    c = io.load(args.input, device=args.device)
    tree = linear.build(c.xyz, c.mask, args.leaf)
    centroids, counts, n_leaves = linear.leaf_centroids(tree, c.xyz)
    n_leaves = int(n_leaves)
    counts = counts.cpu().numpy()[:n_leaves]
    print(f"[obj_rec_ransac_orr_octree] {int(c.count)} points -> "
          f"{n_leaves} full leaves at {args.leaf} "
          f"(mean {counts.mean():.1f} pts/leaf, max {int(counts.max())})")
    if args.html:
        from pcl_tpu_torch.visualization.export import cloud_to_html
        cloud_to_html(args.html,
                      from_numpy(centroids.cpu().numpy()[:n_leaves], device=args.device))
        print(f"[obj_rec_ransac_orr_octree] wrote {args.html}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
