"""CLI: oriented point pairs sampled from a scene cloud (counterpart of
``pcl_tpu/tools/obj_rec_ransac_scene_opps.py``; reference
tools/obj_rec_ransac_scene_opps.cpp), the scene side of
``obj_rec_ransac_model_opps``.

    python -m pcl_tpu_torch.tools.obj_rec_ransac_scene_opps scene.pcd -pair_width 0.15 [-output pairs.pcd]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Scene oriented point pair sampling")
    ap.add_argument("scene")
    ap.add_argument("-pair_width", type=float, default=0.15)
    ap.add_argument("-pairs", type=int, default=256)
    ap.add_argument("-output", help="write pair endpoint cloud here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch.tools.obj_rec_ransac_model_opps import main as opps
    rest = ["-pair_width", str(args.pair_width), "-pairs", str(args.pairs),
            "--device", args.device]
    if args.output:
        rest += ["-output", args.output]
    return opps([args.scene] + rest)


if __name__ == "__main__":
    sys.exit(main())
