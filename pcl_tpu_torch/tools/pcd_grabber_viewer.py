"""CLI: headless PCD-sequence grabber viewer (counterpart of
``pcl_tpu/tools/pcd_grabber_viewer.py``; reference:
tools/pcd_grabber_viewer.cpp): replays a PCD file or a directory of them
through the grabber's pump thread at a given fps, prints per-frame counts
and the measured frame rate, and optionally exports the last frame as HTML.

    python -m pcl_tpu_torch.tools.pcd_grabber_viewer path [-fps 0] [-repeat] [-max_frames 30] [-html out.html] [--device cpu]
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="Replay PCD files via the grabber")
    ap.add_argument("path", help="PCD file, directory of PCDs, or glob")
    ap.add_argument("-fps", type=float, default=0.0)
    ap.add_argument("-repeat", action="store_true")
    ap.add_argument("-max_frames", type=int, default=30)
    ap.add_argument("-html", help="export the last frame here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch.io.grabber import PCDGrabber
    from pcl_tpu_torch.utils.timing import EventFrequency
    freq = EventFrequency()
    frames = []

    def on_cloud(cloud):
        freq.event()
        frames.append(cloud)
        print(f"[pcd_grabber_viewer] frame {len(frames)}: "
              f"{int(cloud.count)} points")

    g = PCDGrabber(args.path, fps=args.fps, repeat=args.repeat, device=args.device)
    g.register_callback(on_cloud)
    g.start()
    t0 = time.perf_counter()
    while g.is_running() and len(frames) < args.max_frames \
            and time.perf_counter() - t0 < 10.0:
        time.sleep(0.005)
    g.stop()
    print(f"[pcd_grabber_viewer] {len(frames)} frames, "
          f"{freq.frequency():.1f} fps")
    if args.html and frames:
        from pcl_tpu_torch.visualization.export import cloud_to_html
        cloud_to_html(args.html, frames[-1])
        print(f"[pcd_grabber_viewer] wrote {args.html}")
    return 0 if frames else 1


if __name__ == "__main__":
    sys.exit(main())
