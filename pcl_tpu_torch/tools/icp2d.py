"""CLI: ICP in the xy plane (counterpart of ``pcl_tpu/tools/icp2d.py``).

    python -m pcl_tpu_torch.tools.icp2d source.pcd target.pcd out.pcd
        [-max_dist D] [-iters N] [--device cpu]

Both clouds are flattened to z = 0. Each iteration matches the moved
source to its nearest target points (the exact 1-NN, kernel B1 on the card)
within ``max_dist``, estimates the planar closed form on the device, and
composes the transform on the host, as the JAX tool does; it stops with
fewer than three matches or when the increment is within 1e-7 of the
identity.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Planar ICP (x, y, theta)")
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("output")
    ap.add_argument("-max_dist", type=float, default=0.5)
    ap.add_argument("-iters", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.registration.estimation import estimate_2d
    from pcl_tpu_torch.search import bruteforce

    src = io.load(args.source, device=args.device)
    tgt = io.load(args.target, device=args.device)
    dev = src.xyz.device
    sxy = src.xyz[src.mask].cpu().numpy().copy()
    sxy[:, 2] = 0.0
    txy = tgt.xyz[tgt.mask].clone()
    txy[:, 2] = 0.0
    tmask = torch.ones(txy.shape[0], dtype=torch.bool, device=dev)
    gate = float(np.float32(args.max_dist) ** 2)
    T = np.eye(4, dtype=np.float32)
    for _ in range(args.iters):
        cur = torch.from_numpy(sxy @ T[:3, :3].T + T[:3, 3]).to(dev)
        idx, d2 = bruteforce.nn1(txy, tmask, cur)
        ok = d2 < gate
        if int(ok.sum()) < 3:
            break
        Td = estimate_2d(cur, txy[idx.long()], ok.to(torch.float32)).cpu().numpy()
        T = Td @ T
        if np.abs(Td - np.eye(4)).max() < 1e-7:
            break
    print(f"[icp2d] t=({T[0, 3]:.4f},{T[1, 3]:.4f}) "
          f"theta={float(np.arctan2(T[1, 0], T[0, 0])):.4f}")
    out = src.with_xyz(transform_points(torch.from_numpy(T).to(dev), src.xyz))
    io.save(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
