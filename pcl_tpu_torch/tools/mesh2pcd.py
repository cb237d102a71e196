"""CLI: mesh -> cloud via virtual depth scanning (counterpart of
``pcl_tpu/tools/mesh2pcd.py``; reference: tools/mesh2pcd.cpp — renders the
mesh from a view sphere and back-projects the depth buffers;
``tools.virtual_scanner.scan_views`` at 16 views of 128 x 128 on 200,000
surface samples by default).

    python -m pcl_tpu_torch.tools.mesh2pcd mesh.ply out.pcd [-n_views 16] [-resolution 128] [-dense_samples 200000] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert a mesh to a scanned cloud")
    ap.add_argument("input", help=".ply or .obj mesh")
    ap.add_argument("output")
    ap.add_argument("-n_views", type=int, default=16)
    ap.add_argument("-resolution", type=int, default=128)
    ap.add_argument("-dense_samples", type=int, default=200000,
                    help="surface pre-samples backing the z-buffer")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.tools.virtual_scanner import scan_views
    pts = scan_views(args.input, args.n_views, args.resolution, args.dense_samples,
                     device=args.device)
    io.save(args.output, from_numpy(pts, device=args.device))
    print(f"[mesh2pcd] {args.n_views} views -> {len(pts)} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
