"""CLI: keep the points inside the convex hull of a second cloud
(counterpart of ``pcl_tpu/tools/crop_to_hull.py``).

    python -m pcl_tpu_torch.tools.crop_to_hull in.pcd hull.pcd out.pcd [--outside] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Keep points inside the convex hull of a second cloud")
    ap.add_argument("input")
    ap.add_argument("hull_cloud")
    ap.add_argument("output")
    ap.add_argument("--outside", action="store_true", help="keep outside instead")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import compact
    from pcl_tpu_torch.filters.crop_hull import crop_hull
    from pcl_tpu_torch.surface import convex_hull

    c = io.load(args.input, device=args.device)
    verts, faces = convex_hull(io.load(args.hull_cloud, device=args.device), dim=3)
    out = compact(crop_hull(c, verts, faces, negative=args.outside))
    io.save(args.output, out)
    print(f"[crop_to_hull] {int(c.count)} -> {int(out.count)} points (hull {len(faces)} facets)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
