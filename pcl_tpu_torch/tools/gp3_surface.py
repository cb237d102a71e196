"""CLI: greedy projection triangulation of a cloud (counterpart of
``pcl_tpu/tools/gp3_surface.py``).

    python -m pcl_tpu_torch.tools.gp3_surface in.pcd out.ply [-radius 0.025] [-mu 2.5] [-k 16] [--device cpu]

Normals are estimated (k nearest) when the cloud has none; outputs as
``tools.marching_cubes_reconstruction.save_mesh`` writes them.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Greedy projection triangulation")
    ap.add_argument("input")
    ap.add_argument("output", help=".ply mesh or .pcd vertices")
    ap.add_argument("-radius", type=float, default=0.025, help="search radius")
    ap.add_argument("-mu", type=float, default=2.5)
    ap.add_argument("-k", type=int, default=16, help="max nearest neighbors")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import features, io
    from pcl_tpu_torch.surface import greedy_projection_triangulation
    from pcl_tpu_torch.tools.marching_cubes_reconstruction import save_mesh

    c = io.load(args.input, device=args.device)
    if "normal" not in c.attrs:
        c = features.estimate_normals(c, k=args.k)
    verts, tris = greedy_projection_triangulation(c, args.radius, mu=args.mu, k=args.k)
    save_mesh(args.output, verts, tris)
    print(f"[gp3] {len(verts)} vertices, {len(tris)} triangles -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
