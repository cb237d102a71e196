"""CLI: convex or concave hull of a cloud (counterpart of
``pcl_tpu/tools/compute_hull.py``).

    python -m pcl_tpu_torch.tools.compute_hull in.pcd out.ply [-alpha 0.1] [--device cpu]

``-alpha`` > 0 takes the 3-D concave hull (alpha shape) with that alpha,
whose facets are triangles; the JAX tool takes the 2-D one there and fails
writing its edges as triangles (ROADMAP C65). Outputs as
``tools.marching_cubes_reconstruction.save_mesh`` writes them.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Compute the hull mesh of a cloud")
    ap.add_argument("input")
    ap.add_argument("output", help=".ply mesh or .pcd vertices")
    ap.add_argument("-alpha", type=float, default=0.0, help=">0 -> concave hull with this alpha")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.surface import concave_hull, convex_hull
    from pcl_tpu_torch.tools.marching_cubes_reconstruction import save_mesh

    c = io.load(args.input, device=args.device)
    if args.alpha > 0:
        verts, faces = concave_hull(c, alpha=args.alpha, dim=3)
    else:
        verts, faces = convex_hull(c, dim=3)
    save_mesh(args.output, verts, faces)
    print(f"[compute_hull] {int(c.count)} pts -> {len(verts)} verts, {len(faces)} facets")
    return 0


if __name__ == "__main__":
    sys.exit(main())
