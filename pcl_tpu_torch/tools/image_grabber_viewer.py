"""CLI: headless depth-image-sequence viewer (counterpart of
``pcl_tpu/tools/image_grabber_viewer.py``; reference:
tools/image_grabber_viewer.cpp, an ImageGrabber into a CloudViewer): per-frame
counts and an optional HTML export of the first frame.

    python -m pcl_tpu_torch.tools.image_grabber_viewer frames_dir [-focal 525] [-max_frames 30] [-html out.html] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Replay depth images (headless)")
    ap.add_argument("dir", help="directory of .npy depth frames")
    ap.add_argument("-focal", type=float, default=525.0)
    ap.add_argument("-max_frames", type=int, default=30)
    ap.add_argument("-html", help="export the first frame here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch.io.grabber import ImageGrabber
    g = ImageGrabber(args.dir, focal=args.focal, device=args.device)
    n = 0
    for cloud in g.frames():
        if n >= args.max_frames:
            break
        print(f"[image_grabber_viewer] frame {n}: {int(cloud.count)} points "
              f"({cloud.width}x{cloud.height})")
        if n == 0 and args.html:
            from pcl_tpu_torch.visualization.export import cloud_to_html
            cloud_to_html(args.html, cloud)
            print(f"[image_grabber_viewer] wrote {args.html}")
        n += 1
    print(f"[image_grabber_viewer] {n} frames")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
