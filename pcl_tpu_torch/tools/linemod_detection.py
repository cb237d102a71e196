"""CLI: detect LINEMOD templates in an organized RGB cloud (counterpart of
``pcl_tpu/tools/linemod_detection.py``; reference tools/linemod_detection.cpp).

    python -m pcl_tpu_torch.tools.linemod_detection scene.pcd t.npz [t2.lmt ...] -threshold 0.75

Templates are ``.npz`` files or PCL's ``.lmt``/``.sqmmt`` byte format.
"""
import argparse
import sys


def load_template_files(paths):
    """The templates of every ``.npz``, ``.lmt`` or ``.sqmmt`` file."""
    import numpy as np
    from pcl_tpu_torch.recognition.linemod import LinemodTemplate
    from pcl_tpu_torch.recognition.linemod_io import load_templates
    out = []
    for p in paths:
        if p.endswith((".lmt", ".sqmmt")):
            out.extend(load_templates(p))
        else:
            z = np.load(p)
            out.append(LinemodTemplate(offsets=z["offsets"], bins=z["bins"],
                                       modality=z["modality"], height=int(z["height"]),
                                       width=int(z["width"])))
    return out


def organized_maps(cloud):
    """``(rgb, xyz, valid)`` images of an organized cloud."""
    H, W = cloud.height, cloud.width
    return (cloud.attrs["rgb"].reshape(H, W, 3), cloud.xyz.reshape(H, W, 3),
            cloud.mask.reshape(H, W))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Detect LINEMOD templates")
    ap.add_argument("scene", help="organized PCD with rgb")
    ap.add_argument("templates", nargs="+",
                    help=".npz template files or reference-format .lmt/.sqmmt files")
    ap.add_argument("-threshold", type=float, default=0.75)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.recognition.linemod import (build_modality_maps, detect_templates,
                                                   spread_quantized_map)
    c = io.load(args.scene, device=args.device)
    if c.height <= 1:
        raise SystemExit("linemod_detection requires an organized cloud")
    qmaps = build_modality_maps(*organized_maps(c))
    smaps = [spread_quantized_map(q) for q in qmaps]
    dets = detect_templates(smaps, load_template_files(args.templates), threshold=args.threshold)
    for d in dets:
        print(f"[linemod_detection] template={d.template_id} "
              f"score={d.score:.3f} at (y={d.y}, x={d.x})")
    if not dets:
        print("[linemod_detection] no detections")
    return 0


if __name__ == "__main__":
    sys.exit(main())
