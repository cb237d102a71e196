"""CLI: replay a depth-image sequence and save organized PCDs (counterpart of
``pcl_tpu/tools/image_grabber_saver.py``; reference:
tools/image_grabber_saver.cpp): an ImageGrabber over a directory of ``.npy``
depth frames (float metres), each frame written as a PCD.

    python -m pcl_tpu_torch.tools.image_grabber_saver frames_dir out_dir [-focal 525] [-max_frames 100] [--device cpu]
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Depth image sequence -> PCD files")
    ap.add_argument("dir", help="directory of .npy depth frames (float meters)")
    ap.add_argument("out_dir")
    ap.add_argument("-focal", type=float, default=525.0)
    ap.add_argument("-max_frames", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.io.grabber import ImageGrabber
    os.makedirs(args.out_dir, exist_ok=True)
    g = ImageGrabber(args.dir, focal=args.focal, device=args.device)
    n = 0
    for cloud in g.frames():
        if n >= args.max_frames:
            break
        out = os.path.join(args.out_dir, f"frame_{n:06d}.pcd")
        io.save(out, cloud)
        print(f"[image_grabber_saver] {out} ({int(cloud.count)} points)")
        n += 1
    print(f"[image_grabber_saver] {n} frames saved")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
