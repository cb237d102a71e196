"""CLI: sample points from a mesh surface (counterpart of
``pcl_tpu/tools/mesh_sampling.py``; reference: tools/mesh_sampling.cpp):
area-weighted triangle choice and barycentric draws from numpy's
``default_rng(seed)``, the JAX tool's draws bit for bit (ROADMAP C93).

    python -m pcl_tpu_torch.tools.mesh_sampling mesh.ply out.pcd [-n_samples 100000] [-seed 0] [--device cpu]
"""
import argparse
import sys


def sample_surface(tri, n, rng):
    """``n`` points on the triangles ``tri`` ``[F, 3, 3]``, each triangle
    chosen in proportion to its area."""
    import numpy as np

    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    t = rng.choice(len(tri), size=n, p=area / area.sum())
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip] = 1 - u[flip]
    v[flip] = 1 - v[flip]
    return (tri[t, 0] * (1 - u - v)[:, None] + tri[t, 1] * u[:, None]
            + tri[t, 2] * v[:, None])


def load_mesh(path, device):
    """``(cloud, faces)`` of a ``.obj`` or ``.ply`` mesh."""
    if str(path).lower().endswith(".obj"):
        from pcl_tpu_torch.io.obj import load_mesh as load
    else:
        from pcl_tpu_torch.io.ply import load_mesh as load
    return load(path, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Uniformly sample a triangle mesh")
    ap.add_argument("input", help=".ply or .obj mesh")
    ap.add_argument("output")
    ap.add_argument("-n_samples", type=int, default=100000)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np

    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy, to_numpy
    cloud, faces = load_mesh(args.input, args.device)
    if faces is None or len(faces) == 0:
        raise SystemExit("input has no faces")
    xyz, _ = to_numpy(cloud)
    tri = xyz[np.asarray(faces)]
    p = sample_surface(tri, args.n_samples, np.random.default_rng(args.seed))
    io.save(args.output, from_numpy(p.astype(np.float32), device=args.device))
    print(f"[mesh_sampling] {len(tri)} triangles -> {args.n_samples} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
