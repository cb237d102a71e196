"""CLI: implicit-surface reconstruction (Hoppe SDF or RBF) to a mesh
(counterpart of ``pcl_tpu/tools/marching_cubes_reconstruction.py``).

    python -m pcl_tpu_torch.tools.marching_cubes_reconstruction in.pcd out.ply [-method hoppe|rbf] [-grid_res 48] [-k 16] [--device cpu]

Normals are estimated (k nearest) when the cloud has none. A ``.ply``,
``.vtk`` or ``.ifs`` output holds the mesh, a ``.pcd`` output its vertices.
"""
import argparse
import sys


def save_mesh(path, verts, tris) -> None:
    """Write a mesh: ``.ply``, legacy ``.vtk`` and ``.ifs`` with its faces,
    ``.pcd`` its vertices only."""
    import numpy as np

    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.io.formats_extra import save_ifs, save_vtk

    low = str(path).lower()
    if low.endswith(".vtk"):
        return save_vtk(path, np.asarray(verts), polygons=np.asarray(tris))
    if low.endswith(".ifs"):
        return save_ifs(path, np.asarray(verts), triangles=np.asarray(tris))
    cloud = make_cloud(np.asarray(verts, np.float32), device="cpu")
    if low.endswith(".ply"):
        io.save_ply(path, cloud, faces=np.asarray(tris, np.int32))
    else:
        io.save(path, cloud)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Marching-cubes style reconstruction")
    ap.add_argument("input")
    ap.add_argument("output", help=".ply/.vtk/.ifs mesh or .pcd vertices")
    ap.add_argument("-method", choices=("hoppe", "rbf"), default="hoppe")
    ap.add_argument("-grid_res", type=int, default=48)
    ap.add_argument("-k", type=int, default=16, help="normal-estimation neighbors")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import features, io
    from pcl_tpu_torch.surface import marching_cubes_rbf, reconstruct_hoppe

    c = io.load(args.input, device=args.device)
    if "normal" not in c.attrs:
        c = features.estimate_normals(c, k=args.k)
    if args.method == "hoppe":
        verts, tris = reconstruct_hoppe(c, resolution=args.grid_res)
    else:
        verts, tris = marching_cubes_rbf(c, resolution=args.grid_res)
    save_mesh(args.output, verts, tris)
    print(f"[marching_cubes] {args.method}: {len(verts)} vertices, "
          f"{len(tris)} triangles -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
