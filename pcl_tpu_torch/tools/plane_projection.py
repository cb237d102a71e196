"""CLI: fit a plane by RANSAC and project the cloud onto it (counterpart of
``pcl_tpu/tools/plane_projection.py``; reference: tools/plane_projection.cpp
with ProjectInliers' semantics).

    python -m pcl_tpu_torch.tools.plane_projection in.pcd out.pcd [-thresh 0.01] [-coeffs a,b,c,d] [--device cpu]

The JAX tool draws its hypotheses from ``PRNGKey(0)``, a stream torch cannot
draw (ROADMAP C17): here a generator seeded 0 on the cloud's device draws
them, and ``main(draws=(idx, sub))`` takes them from the caller instead
(``sac.ransac_core``'s indices and subset).
"""
import argparse
import sys

import numpy as np


def main(argv=None, draws=None):
    ap = argparse.ArgumentParser(description="Project a cloud onto its dominant plane")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-thresh", type=float, default=0.01,
                    help="RANSAC inlier threshold for the plane fit")
    ap.add_argument("-coeffs", default=None,
                    help="a,b,c,d — skip the fit and use this plane")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from pcl_tpu_torch import io, sac
    from pcl_tpu_torch.filters import project_inliers

    c = io.load(args.input, device=args.device)
    model = sac.PlaneModel()
    if args.coeffs:
        coeffs = torch.tensor([float(v) for v in args.coeffs.split(",")],
                              dtype=torch.float32, device=c.xyz.device)
    else:
        if draws is None:
            res = sac.ransac(model, c.xyz, c.mask, args.thresh)
        else:
            res = sac.ransac_core(model, c.xyz, c.mask, args.thresh, *draws)
        coeffs = res.coefficients
        print(f"[plane_projection] plane "
              f"{np.array2string(coeffs.cpu().numpy(), precision=6)} "
              f"({int(res.num_inliers)} inliers)")
    out = project_inliers(c, model, coeffs)
    io.save(args.output, out)
    print(f"[plane_projection] wrote {int(out.count)} projected points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
