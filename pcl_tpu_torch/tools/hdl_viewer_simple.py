"""CLI: headless Velodyne HDL pcap viewer (counterpart of
``pcl_tpu/tools/hdl_viewer_simple.py``; reference: tools/hdl_viewer_simple.cpp,
a live CloudViewer on an HDL grabber): replays the pcap, prints one line per
sweep, and optionally exports the first sweep as HTML.

    python -m pcl_tpu_torch.tools.hdl_viewer_simple capture.pcap [-model HDL32E] [-max_sweeps 10] [-html out.html] [--device cpu]
"""
import argparse
import sys


def main(argv=None, model="HDL32E", tag="hdl_viewer_simple"):
    ap = argparse.ArgumentParser(description="Replay a Velodyne pcap (headless)")
    ap.add_argument("pcap")
    ap.add_argument("-model", default=model, choices=["HDL32E", "VLP16"])
    ap.add_argument("-max_sweeps", type=int, default=10)
    ap.add_argument("-html", help="export the first sweep as HTML")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from pcl_tpu_torch.io.velodyne import PcapVelodyneGrabber
    g = PcapVelodyneGrabber(args.pcap, model=args.model, device=args.device)
    n = 0
    for i, cloud in enumerate(g._sweeps()):
        if i >= args.max_sweeps:
            break
        xyz = cloud.xyz[cloud.mask].cpu().numpy()
        rng = np.linalg.norm(xyz, axis=1)
        print(f"[{tag}] sweep {i}: {len(xyz)} returns, "
              f"range {rng.min():.2f}..{rng.max():.2f} m")
        if i == 0 and args.html:
            from pcl_tpu_torch.visualization.export import cloud_to_html
            cloud_to_html(args.html, cloud, title=f"{args.pcap} sweep 0")
            print(f"[{tag}] wrote {args.html}")
        n += 1
    print(f"[{tag}] {n} sweeps replayed from {args.pcap}")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
