"""CLI: match one LINEMOD template against an organized RGB cloud
(counterpart of ``pcl_tpu/tools/match_linemod_template.py``; reference
tools/match_linemod_template.cpp).

    python -m pcl_tpu_torch.tools.match_linemod_template scene.pcd t.npz -threshold 0.6
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Match one LINEMOD template")
    ap.add_argument("scene", help="organized PCD with rgb")
    ap.add_argument("template", help=".npz template file")
    ap.add_argument("-threshold", type=float, default=0.6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch.tools.linemod_detection import main as detect
    return detect([args.scene, args.template, "-threshold", str(args.threshold),
                   "--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
