"""CLI: RANSAC plane segmentation (counterpart of
``pcl_tpu/tools/sac_segmentation_plane.py``).

    python -m pcl_tpu_torch.tools.sac_segmentation_plane in.pcd out.pcd -thresh 0.05 \
        [-neg] [-refine] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Extract the dominant plane with RANSAC")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-thresh", type=float, default=0.05)
    ap.add_argument("-neg", action="store_true",
                    help="write the NON-plane points instead of the inliers")
    ap.add_argument("-refine", action="store_true",
                    help="least-squares refine the plane on its inliers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io, sac, segmentation
    c = io.load(args.input, device=args.device)
    res = segmentation.sac_segmentation(c, sac.PlaneModel(), args.thresh, refine=args.refine)
    np.set_printoptions(precision=6, suppress=True)
    print(f"[sac_segmentation_plane] inliers={int(res.num_inliers)}/{int(c.count)}"
          f" coefficients={res.coefficients.cpu().numpy()}")
    io.save(args.output, c.with_mask(~res.inliers if args.neg else res.inliers))
    return 0 if bool(res.valid) else 1


if __name__ == "__main__":
    sys.exit(main())
