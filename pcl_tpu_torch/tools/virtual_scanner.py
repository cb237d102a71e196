"""CLI: virtual scanner (counterpart of ``pcl_tpu/tools/virtual_scanner.py``;
reference: tools/virtual_scanner.cpp) — simulate depth scans of a mesh from
viewpoints on a sphere and write the merged cloud.

    python -m pcl_tpu_torch.tools.virtual_scanner mesh.obj out.pcd [-n_views 8] [-resolution 96] [-dense_samples 100000] [--device cpu]

The mesh is sampled densely on the host (numpy's ``default_rng(seed)``, the
JAX tool's draws bit for bit, ROADMAP C93), each view is a
``simulation.render_depth`` z-buffer of those samples on the device and its
``fusion.depth_to_vertex_map``, taken back to the world on the host.
"""
import argparse
import sys

import numpy as np


def _look_at(eye, center):
    z = center - eye
    z = z / np.linalg.norm(z)
    up = np.float32([0, 0, 1]) if abs(z[2]) < 0.95 else np.float32([0, 1, 0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def scan_views(mesh_path, n_views, resolution, dense_samples, seed=0, device=None):
    """Render depth from viewpoints on a sphere around the mesh; returns the
    merged back-projected points [N,3] (z-buffer backed by dense surface
    samples — the analog of the reference's VTK ray casting)."""
    import torch

    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.fusion import Intrinsics, depth_to_vertex_map
    from pcl_tpu_torch.simulation import render_depth
    from pcl_tpu_torch.tools.mesh_sampling import load_mesh, sample_surface
    cloud, faces = load_mesh(mesh_path, device)
    xyz = cloud.xyz.cpu().numpy()[cloud.mask.cpu().numpy()]
    if faces is not None and len(faces):
        tri = xyz[np.asarray(faces)]
        xyz = sample_surface(tri, dense_samples, np.random.default_rng(seed)).astype(np.float32)
    dense = from_numpy(xyz, device=device)
    dev = dense.xyz.device
    center = xyz.mean(0)
    radius = 2.5 * float(np.linalg.norm(xyz - center, axis=1).max() + 1e-6)
    H = W = int(resolution)
    intr = Intrinsics(fx=W * 0.8, fy=W * 0.8, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    out = []
    for k in range(n_views):
        phi = np.arccos(1 - 2 * (k + 0.5) / n_views)
        theta = np.pi * (1 + 5 ** 0.5) * k
        eye = center + radius * np.float32([
            np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)])
        pose = _look_at(eye.astype(np.float32), center.astype(np.float32))
        d = render_depth(dense, torch.as_tensor(pose, device=dev), intr, H, W)
        vm = depth_to_vertex_map(d, intr).cpu().numpy()
        pts_cam = vm[d.cpu().numpy() > 0]
        pts_w = pts_cam @ pose[:3, :3].T + pose[:3, 3]
        out.append(pts_w.astype(np.float32))
    return np.concatenate(out, 0) if out else np.zeros((0, 3), np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Simulate scans of a mesh")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-n_views", type=int, default=8)
    ap.add_argument("-resolution", type=int, default=96)
    ap.add_argument("-dense_samples", type=int, default=100000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy
    pts = scan_views(args.input, args.n_views, args.resolution, args.dense_samples,
                     device=args.device)
    io.save(args.output, from_numpy(pts, device=args.device))
    print(f"[virtual_scanner] {args.n_views} views -> {len(pts)} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
