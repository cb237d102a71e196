"""CLI: z-projection of a cloud's voxel occupancy (counterpart of
``pcl_tpu/tools/obj_rec_ransac_orr_octree_zprojection.py``; reference
tools/obj_rec_ransac_orr_octree_zprojection.cpp): for each (x, y) pillar
of ``-leaf`` cells, the number of occupied z levels, written as a PGM
image scaled to 255.

    python -m pcl_tpu_torch.tools.obj_rec_ransac_orr_octree_zprojection in.pcd out.pgm -leaf 0.05
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Octree occupancy z-projection")
    ap.add_argument("input")
    ap.add_argument("output", help="PGM image of the z-projected occupancy")
    ap.add_argument("-leaf", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from pcl_tpu_torch import io
    c = io.load(args.input, device=args.device)
    xyz = c.xyz[c.mask]
    cells = torch.floor((xyz - xyz.amin(0)) / args.leaf).to(torch.int64)
    top = cells.amax(0)
    nx, ny, zmax = int(top[0]) + 1, int(top[1]) + 1, int(top[2]) + 2
    # occupied (x, y, z) cells, counted per (x, y) pillar
    uniq = torch.unique((cells[:, 0] * ny + cells[:, 1]) * zmax + cells[:, 2])
    pillar = torch.bincount(uniq // zmax, minlength=nx * ny).reshape(nx, ny)
    peak = int(pillar.max())
    img = (pillar.to(torch.float32) / max(peak, 1) * 255).to(torch.uint8).cpu().numpy()
    with open(args.output, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
    print(f"[obj_rec_ransac_orr_octree_zprojection] {nx}x{ny} pillars, "
          f"max height {peak} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
