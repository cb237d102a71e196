"""CLI: extract a LINEMOD template from a region of an organized RGB cloud
(counterpart of ``pcl_tpu/tools/train_linemod_template.py``; reference
tools/train_linemod_template.cpp).

    python -m pcl_tpu_torch.tools.train_linemod_template in.pcd out.npz [-region y0 x0 h w]

``out`` ending in ``.lmt`` or ``.sqmmt`` is written in PCL's byte format.
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a LINEMOD template")
    ap.add_argument("input", help="organized PCD with rgb")
    ap.add_argument("output",
                    help=".npz template, or .lmt/.sqmmt for the reference pcl::LINEMOD byte format")
    ap.add_argument("-region", type=int, nargs=4, metavar=("y0", "x0", "h", "w"),
                    default=None, help="defaults to the valid bounding box")
    ap.add_argument("-n_features", type=int, default=63)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch import io
    from pcl_tpu_torch.recognition.linemod import build_modality_maps, extract_template
    from pcl_tpu_torch.tools.linemod_detection import organized_maps
    c = io.load(args.input, device=args.device)
    if c.height <= 1:
        raise SystemExit("train_linemod_template requires an organized cloud")
    rgb, xyz, valid = organized_maps(c)
    qmaps = build_modality_maps(rgb, xyz, valid)
    if args.region is None:
        ys, xs = np.nonzero(valid.cpu().numpy())
        region = (int(ys.min()), int(xs.min()),
                  int(ys.max() - ys.min() + 1), int(xs.max() - xs.min() + 1))
    else:
        region = tuple(args.region)
    t = extract_template(qmaps, region, n_features=args.n_features)
    if args.output.endswith((".lmt", ".sqmmt")):
        from pcl_tpu_torch.recognition.linemod_io import save_templates
        save_templates(args.output, [t])
    else:
        np.savez(args.output, offsets=t.offsets, bins=t.bins, modality=t.modality,
                 height=t.height, width=t.width)
    print(f"[train_linemod_template] region {region} -> {len(t.offsets)} features")
    return 0


if __name__ == "__main__":
    sys.exit(main())
