"""CLI: robust model segmentation (counterpart of
``pcl_tpu/tools/sac_segmentation.py``).

    python -m pcl_tpu_torch.tools.sac_segmentation in.pcd -model plane -thresh 0.01 \
        [-method msac] [-inliers in.pcd] [-outliers out.pcd] [--device cpu]

The hypotheses come from a generator seeded 0, not from the JAX package's
key: the same model is found, by other samples.
"""
import argparse
import sys

MODELS = ("plane", "sphere", "line", "circle3d", "stick")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Segment a geometric model with RANSAC")
    ap.add_argument("input")
    ap.add_argument("-model", default="plane", choices=list(MODELS))
    ap.add_argument("-thresh", type=float, default=0.01)
    ap.add_argument("-method", default="ransac",
                    choices=["ransac", "msac", "lmeds", "mlesac", "rransac"])
    ap.add_argument("-inliers", help="write inlier cloud here")
    ap.add_argument("-outliers", help="write outlier cloud here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io, sac, segmentation
    model = {"plane": sac.PlaneModel(), "sphere": sac.SphereModel(), "line": sac.LineModel(),
             "circle3d": sac.CircleModel3D(), "stick": sac.StickModel()}[args.model]
    c = io.load(args.input, device=args.device)
    res = segmentation.sac_segmentation(c, model, args.thresh, method=args.method)
    np.set_printoptions(precision=6, suppress=True)
    print(f"[sac_segmentation] model={args.model} inliers={int(res.num_inliers)}"
          f"/{int(c.count)} coefficients={res.coefficients.cpu().numpy()}")
    if args.inliers:
        io.save(args.inliers, c.with_mask(res.inliers))
    if args.outliers:
        io.save(args.outliers, c.with_mask(~res.inliers))
    return 0 if bool(res.valid) else 1


if __name__ == "__main__":
    sys.exit(main())
