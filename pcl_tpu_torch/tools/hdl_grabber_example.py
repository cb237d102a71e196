"""CLI: HDL grabber callback example (counterpart of
``pcl_tpu/tools/hdl_grabber_example.py``; reference:
tools/hdl_grabber_example.cpp): registers a sweep callback on the Velodyne
pcap grabber, starts its pump thread and prints each sweep's count. With
``-save PREFIX`` the callback also writes each sweep as ``PREFIX_NNN.pcd``,
the files ``pcap_to_pcd`` writes.

    python -m pcl_tpu_torch.tools.hdl_grabber_example capture.pcap [-model HDL32E] [-timeout 5] [-save PREFIX] [--device cpu]
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="HDL grabber callback example")
    ap.add_argument("pcap")
    ap.add_argument("-model", default="HDL32E", choices=["HDL32E", "VLP16"])
    ap.add_argument("-timeout", type=float, default=5.0)
    ap.add_argument("-save", help="write each sweep as <prefix>_NNN.pcd")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    from pcl_tpu_torch.io.velodyne import PcapVelodyneGrabber
    got = []

    def on_sweep(cloud):
        if args.save:
            io.save(f"{args.save}_{len(got):03d}.pcd", cloud)
        got.append(int(cloud.count))
        print(f"[hdl_grabber_example] sweep {len(got)}: {int(cloud.count)} points")

    g = PcapVelodyneGrabber(args.pcap, model=args.model, device=args.device)
    g.register_callback(on_sweep)
    g.start()
    t0 = time.perf_counter()
    while g.is_running() and time.perf_counter() - t0 < args.timeout:
        time.sleep(0.01)
    g.stop()
    print(f"[hdl_grabber_example] {len(got)} sweeps total")
    return 0 if got else 1


if __name__ == "__main__":
    sys.exit(main())
