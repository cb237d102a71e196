"""CLI: the ObjRecRANSAC hypotheses above an acceptance threshold, by
support (counterpart of ``pcl_tpu/tools/obj_rec_ransac_accepted_hypotheses.py``;
reference tools/obj_rec_ransac_accepted_hypotheses.cpp).

    python -m pcl_tpu_torch.tools.obj_rec_ransac_accepted_hypotheses model.pcd scene.pcd -accept 0.1

Clouds without normals get k-NN normals (k = 16). The draws come from a
generator seeded 0 on the device.
"""
import argparse
import sys


def with_normals(cloud):
    from pcl_tpu_torch import features
    return cloud if "normal" in cloud.attrs else features.estimate_normals(cloud, k=16)


def main(argv=None):
    ap = argparse.ArgumentParser(description="ObjRecRANSAC accepted hypotheses")
    ap.add_argument("model")
    ap.add_argument("scene")
    ap.add_argument("-pair_width", type=float, default=0.15)
    ap.add_argument("-hypotheses", type=int, default=256)
    ap.add_argument("-inlier_dist", type=float, default=0.05)
    ap.add_argument("-accept", type=float, default=0.1,
                    help="minimum support fraction to accept")
    ap.add_argument("-top", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.recognition.orr import _orr_hypotheses, _orr_support, draw_orr_samples
    model = with_normals(io.load(args.model, device=args.device))
    scene = with_normals(io.load(args.scene, device=args.device))
    draws = draw_orr_samples(scene, model, args.pair_width, 0.05, args.hypotheses)
    T = _orr_hypotheses(*draws, scene.xyz, scene.mask, scene.attrs["normal"], model.xyz,
                        model.mask, model.attrs["normal"], args.pair_width, 0.05)
    support = _orr_support(T, model.xyz, model.mask, scene.xyz, scene.mask,
                           args.inlier_dist).cpu().numpy()
    T = T.cpu().numpy()
    order = np.argsort(-support)
    accepted = [(int(i), float(support[i])) for i in order if support[i] >= args.accept]
    print(f"[obj_rec_ransac_accepted_hypotheses] "
          f"{len(accepted)}/{args.hypotheses} accepted (>= {args.accept})")
    np.set_printoptions(precision=4, suppress=True)
    for i, s in accepted[: args.top]:
        print(f"  hyp {i}: support={s:.3f} t={T[i][:3, 3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
