"""CLI: compute a named feature over a cloud (counterpart of
``pcl_tpu/tools/extract_feature.py``; reference: tools/extract_feature.cpp).

    python -m pcl_tpu_torch.tools.extract_feature in.pcd out.npy [-feature fpfh] [-k 16] [-radius 0.1] [--device cpu]

ESF draws its point triples: the JAX tool from ``PRNGKey(0)``, here a
generator seeded 0 on the cloud's device (ROADMAP C17, C50);
``main(esf_draws=tri)`` takes the triples ``[3, S]`` from the caller instead.
"""
import argparse
import sys


def main(argv=None, esf_draws=None):
    ap = argparse.ArgumentParser(description="Compute a named feature over a cloud")
    ap.add_argument("input")
    ap.add_argument("output", help=".npy descriptor matrix output")
    ap.add_argument("-feature", default="fpfh",
                    choices=["normal", "pfh", "fpfh", "vfh", "esf", "shot"])
    ap.add_argument("-k", type=int, default=16, help="neighbors")
    ap.add_argument("-radius", type=float, default=0.1, help="SHOT radius")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import features, io
    from pcl_tpu_torch.features.global_desc import estimate_esf_core
    c = io.load(args.input, device=args.device)
    if args.feature != "esf":
        c = features.estimate_normals(c, k=max(args.k, 8))
    if args.feature == "normal":
        desc = c.attrs["normal"]
    elif args.feature == "pfh":
        desc = features.estimate_pfh(c, k=args.k)
    elif args.feature == "fpfh":
        desc = features.estimate_fpfh(c, k=args.k)
    elif args.feature == "vfh":
        desc = features.estimate_vfh(c)[None]
    elif args.feature == "esf":
        desc = (features.estimate_esf(c) if esf_draws is None
                else estimate_esf_core(c, esf_draws))[None]
    else:
        desc = features.estimate_shot(c, radius=args.radius, k=args.k)
    d = desc.cpu().numpy()
    if d.ndim == 2 and d.shape[0] == c.capacity:
        d = d[c.mask.cpu().numpy()]
    np.save(args.output, d)
    print(f"[extract_feature] {args.feature}: {d.shape} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
