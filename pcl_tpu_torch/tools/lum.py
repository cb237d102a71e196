"""CLI: LUM global alignment of several scans (counterpart of
``pcl_tpu/tools/lum.py``, PCL's tools/lum.cpp): edges between consecutive scans
and between scans whose centroids lie within ``-loop_dist``, nearest-neighbour
correspondences of at most ``-max_corr`` points of each edge's first scan, one
``lum`` solve from identity poses, and each scan written moved as
``<name><suffix><ext>``.

Usage: python -m pcl_tpu_torch.tools.lum scan0.pcd scan1.pcd ... [-loop_dist 5]
         [-corr_dist 2.5] [-max_corr 2048] [-iter 5] [-suffix _out] [--device cpu]

The correspondences are exact 1-NN (``search.bruteforce.nn1``: kernel B1 on
the card) where the JAX tool asks a host kd-tree; the two differ only on exact
ties.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def correspondence_pairs(pts, loop_dist: float, corr_dist: float, max_corr: int, device,
                         log=print):
    """The graph's edges for scans ``pts`` (host ``[N_i, 3]`` arrays in one
    frame): ``[(i, j, src [C,3], dst [C,3]), ...]`` for consecutive scans and
    scans whose centroids lie within ``loop_dist``; an edge keeps the
    subsampled points of scan i whose nearest point of scan j lies within
    ``corr_dist``, and is dropped with fewer than 10."""
    import torch

    from pcl_tpu_torch.core.cloud import _device
    from pcl_tpu_torch.search import bruteforce

    dev = _device(device)
    cents = np.stack([p.mean(axis=0) for p in pts])
    on_dev = [torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(dev) for p in pts]
    pairs = []
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            if j != i + 1 and not np.linalg.norm(cents[i] - cents[j]) < loop_dist:
                continue
            sub = pts[i][:: max(1, len(pts[i]) // max_corr)][:max_corr]
            idx, d2 = bruteforce.nn1(on_dev[j], torch.ones(len(pts[j]), dtype=torch.bool,
                                                            device=dev),
                                     torch.from_numpy(np.ascontiguousarray(sub)).to(dev))
            idx, d2 = idx.cpu().numpy(), d2.cpu().numpy()
            keep = d2 <= corr_dist ** 2
            if keep.sum() < 10:
                continue
            pairs.append((i, j, sub[keep], pts[j][idx[keep]]))
            log(f"[lum] edge {i} -> {j}: {int(keep.sum())} correspondences")
    return pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Globally align multiple scans with a LUM pose graph")
    ap.add_argument("inputs", nargs="+", help="PCD/PLY scans in chain order")
    ap.add_argument("-loop_dist", type=float, default=5.0,
                    help="centroid distance under which two scans form an edge")
    ap.add_argument("-corr_dist", type=float, default=2.5, help="max correspondence distance")
    ap.add_argument("-max_corr", type=int, default=2048, help="correspondence cap per edge")
    ap.add_argument("-iter", type=int, default=5)
    ap.add_argument("-suffix", default="_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.registration.graph import build_edges_from_correspondences, lum

    clouds = [io.load(p, device=args.device) for p in args.inputs]
    pts = [c.xyz[c.mask].cpu().numpy() for c in clouds]
    V = len(clouds)
    pairs = correspondence_pairs(pts, args.loop_dist, args.corr_dist, args.max_corr, args.device)
    if not pairs:
        print("[lum] no edges found", file=sys.stderr)
        return 1

    dev = clouds[0].xyz.device
    es, ed, cs, cd, cv = build_edges_from_correspondences(pairs, args.max_corr, device=dev)
    poses0 = torch.eye(4, dtype=torch.float32, device=dev).repeat(V, 1, 1)
    res = lum(poses0, es, ed, cs, cd, cv, max_iterations=args.iter)
    print(f"[lum] {len(pairs)} edges, {V} vertices, "
          f"residual {float(res.residual):.6g} after {int(res.iterations)} iters")

    for i, (path, c) in enumerate(zip(args.inputs, clouds)):
        out = c.with_xyz(transform_points(res.poses[i], c.xyz))
        base, ext = os.path.splitext(path)
        io.save(base + args.suffix + (ext or ".pcd"), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
