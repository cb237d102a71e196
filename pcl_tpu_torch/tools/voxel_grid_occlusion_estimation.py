"""CLI: voxel occlusion from a viewpoint (counterpart of
``pcl_tpu/tools/voxel_grid_occlusion_estimation.py``; reference
tools/voxel_grid_occlusion_estimation.cpp): an occupied voxel is occluded
when another occupied voxel lies on the segment from its centre to the
viewpoint, sampled as the JAX tool samples it (``n = max(int(L / (leaf /
2)), 1)`` parts, the inner points tested) in float64. The JAX tool walks
the voxels one by one on the host; here every voxel's samples are tested
at once on the device, in chunks. Writes the visible (or, with
``--occluded``, the occluded) voxel centres in ascending cell order.

    python -m pcl_tpu_torch.tools.voxel_grid_occlusion_estimation in.pcd out.pcd -leaf 0.05
"""
import argparse
import sys

_SAMPLES_PER_CHUNK = 1 << 22


def occluded_voxels(xyz, leaf: float, viewpoint):
    """``(cells [K, 3] int64 ascending, centres [K, 3] float64, occluded
    [K] bool)`` for the occupied voxels of ``xyz`` ``[N, 3]`` float32."""
    import torch
    dev = xyz.device
    lo = xyz.amin(0) - leaf                                        # float32, as numpy
    cells = torch.unique(torch.floor((xyz - lo) / leaf).to(torch.int64), dim=0)
    dims = cells.amax(0) + 1
    lin = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]   # ascending
    lo64 = lo.to(torch.float64)
    centres = lo64 + (cells.to(torch.float64) + 0.5) * leaf
    d = torch.as_tensor(viewpoint, dtype=torch.float32, device=dev).to(torch.float64) - centres
    length = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    parts = torch.clamp(torch.floor(length / (leaf * 0.5)).to(torch.int64), min=1)
    occluded = torch.zeros(len(cells), dtype=torch.bool, device=dev)
    most = int(parts.max()) if len(cells) else 1
    chunk = max(1, _SAMPLES_PER_CHUNK // most)
    s = torch.arange(1, most, device=dev, dtype=torch.int64)
    for a in range(0, len(cells), chunk):
        n = parts[a:a + chunk, None]
        p = centres[a:a + chunk, None, :] + d[a:a + chunk, None, :] \
            * (s[None, :].to(torch.float64) / n.to(torch.float64))[..., None]
        key = torch.floor((p - lo64) / leaf).to(torch.int64)
        inside = torch.all((key >= 0) & (key < dims), dim=-1)
        klin = (key[..., 0] * dims[1] + key[..., 1]) * dims[2] + key[..., 2]
        pos = torch.clamp(torch.searchsorted(lin, klin), max=len(lin) - 1)
        hit = inside & (lin[pos] == klin) & (klin != lin[a:a + chunk, None]) \
            & (s[None, :] < n)
        occluded[a:a + chunk] = hit.any(dim=1)
    return cells, centres, occluded


def main(argv=None):
    ap = argparse.ArgumentParser(description="Estimate occluded voxels")
    ap.add_argument("input")
    ap.add_argument("output", help="PCD of FREE (visible) occupied-voxel centers")
    ap.add_argument("-leaf", type=float, default=0.05)
    ap.add_argument("-viewpoint", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    ap.add_argument("--occluded", action="store_true",
                    help="write occluded voxel centers instead")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy
    c = io.load(args.input, device=args.device)
    cells, centres, occluded = occluded_voxels(c.xyz[c.mask], float(args.leaf), args.viewpoint)
    sel = occluded if args.occluded else ~occluded
    out = centres[sel].to(torch.float32).cpu().numpy().reshape(-1, 3)
    io.save(args.output, from_numpy(out.astype(np.float32), device=args.device))
    n_occ = int(occluded.sum())
    print(f"[voxel_occlusion] {len(cells)} occupied: {len(cells) - n_occ} visible, "
          f"{n_occ} occluded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
