"""CLI: oriented point pairs sampled from a model cloud (counterpart of
``pcl_tpu/tools/obj_rec_ransac_model_opps.py``; reference
tools/obj_rec_ransac_model_opps.cpp): prints the pairs' statistics and can
write their end points as a cloud.

    python -m pcl_tpu_torch.tools.obj_rec_ransac_model_opps model.pcd -pair_width 0.15 [-output pairs.pcd]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Model oriented point pair sampling")
    ap.add_argument("model")
    ap.add_argument("-pair_width", type=float, default=0.15)
    ap.add_argument("-pairs", type=int, default=256)
    ap.add_argument("-output", help="write pair endpoint cloud here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.recognition.orr import sample_oriented_point_pairs
    from pcl_tpu_torch.tools.obj_rec_ransac_accepted_hypotheses import with_normals
    c = with_normals(io.load(args.model, device=args.device))
    i1, i2, valid = (v.cpu().numpy() for v in sample_oriented_point_pairs(
        c, args.pair_width, n_pairs=args.pairs))
    xyz = c.xyz.cpu().numpy()
    d = np.linalg.norm(xyz[i2[valid]] - xyz[i1[valid]], axis=-1)
    print(f"[obj_rec_ransac_model_opps] {int(valid.sum())}/{args.pairs} pairs "
          f"at width {args.pair_width} "
          f"(measured {d.mean():.4f} +- {d.std():.4f})" if valid.any()
          else f"[obj_rec_ransac_model_opps] 0/{args.pairs} pairs — "
               f"no partners at width {args.pair_width}")
    if args.output and valid.any():
        pts = np.concatenate([xyz[i1[valid]], xyz[i2[valid]]])
        io.save(args.output, from_numpy(pts.astype(np.float32), device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
