"""CLI: replay a Velodyne pcap into one PCD per sweep (counterpart of
``pcl_tpu/tools/pcap_to_pcd.py``; reference: tools/hdl_grabber_example.cpp
with the openni_pcd_recorder pattern, headless), synchronously, without the
pump thread.

    python -m pcl_tpu_torch.tools.pcap_to_pcd capture.pcap out_prefix [-model VLP16] [-max_sweeps 0] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Velodyne pcap -> PCD sweeps")
    ap.add_argument("input", help=".pcap file")
    ap.add_argument("out_prefix", help="writes <prefix>_NNN.pcd per sweep")
    ap.add_argument("-model", default="VLP16")
    ap.add_argument("-max_sweeps", type=int, default=0, help="0 = all")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.io.velodyne import PcapVelodyneGrabber
    g = PcapVelodyneGrabber(args.input, model=args.model, device=args.device)
    count = 0
    for cloud in g._produce():
        io.save(f"{args.out_prefix}_{count:03d}.pcd", cloud)
        count += 1
        if args.max_sweeps and count >= args.max_sweeps:
            break
    print(f"[pcap_to_pcd] {count} sweeps written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
