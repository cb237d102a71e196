"""CLI: Poisson surface reconstruction (counterpart of
``pcl_tpu/tools/poisson_reconstruction.py``).

    python -m pcl_tpu_torch.tools.poisson_reconstruction in.pcd out.ply [-depth 5] [-k 16] [--device cpu]

Normals are estimated (k nearest); outputs as
``tools.marching_cubes_reconstruction.save_mesh`` writes them.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Poisson indicator-field reconstruction")
    ap.add_argument("input")
    ap.add_argument("output", help=".ply mesh or .pcd vertices")
    ap.add_argument("-depth", type=int, default=5, help="octree depth (grid 2^depth)")
    ap.add_argument("-k", type=int, default=16, help="normal neighborhood")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import features, io
    from pcl_tpu_torch.surface import poisson_reconstruction
    from pcl_tpu_torch.tools.marching_cubes_reconstruction import save_mesh

    c = features.estimate_normals(io.load(args.input, device=args.device), k=args.k)
    verts, faces = poisson_reconstruction(c, depth=args.depth)
    save_mesh(args.output, verts, faces)
    print(f"[poisson] {int(c.count)} pts -> {len(verts)} verts {len(faces)} tris")
    return 0


if __name__ == "__main__":
    sys.exit(main())
