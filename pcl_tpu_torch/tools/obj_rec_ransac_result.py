"""CLI: ObjRecRANSAC recognition of a model in a scene (counterpart of
``pcl_tpu/tools/obj_rec_ransac_result.py``; reference
tools/obj_rec_ransac_result.cpp): prints the best transform and its
support, and can write the aligned model.

    python -m pcl_tpu_torch.tools.obj_rec_ransac_result model.pcd scene.pcd -pair_width 0.15 [-output aligned.pcd]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="ObjRecRANSAC: model-in-scene detection")
    ap.add_argument("model")
    ap.add_argument("scene")
    ap.add_argument("-pair_width", type=float, default=0.15,
                    help="oriented point pair sampling distance")
    ap.add_argument("-hypotheses", type=int, default=256)
    ap.add_argument("-inlier_dist", type=float, default=0.05)
    ap.add_argument("-output", help="write the aligned model cloud here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.transforms import transform_cloud
    from pcl_tpu_torch.recognition.orr import obj_rec_ransac
    from pcl_tpu_torch.tools.obj_rec_ransac_accepted_hypotheses import with_normals
    model = with_normals(io.load(args.model, device=args.device))
    scene = with_normals(io.load(args.scene, device=args.device))
    T, support = obj_rec_ransac(model, scene, pair_dist=args.pair_width,
                                n_hypotheses=args.hypotheses, inlier_dist=args.inlier_dist)
    np.set_printoptions(precision=6, suppress=True)
    print(f"[obj_rec_ransac_result] support={support:.3f}")
    print(T)
    if args.output:
        io.save(args.output, transform_cloud(torch.as_tensor(T, device=model.xyz.device), model))
    return 0


if __name__ == "__main__":
    sys.exit(main())
