"""CLI: headless VLP-16 pcap viewer (counterpart of
``pcl_tpu/tools/vlp_viewer.py``; reference: tools/vlp_viewer.cpp): the VLP-16
form of ``hdl_viewer_simple``.

    python -m pcl_tpu_torch.tools.vlp_viewer capture.pcap [-max_sweeps 10] [-html out.html] [--device cpu]
"""
import sys

from pcl_tpu_torch.tools.hdl_viewer_simple import main as _main


def main(argv=None):
    return _main(argv, model="VLP16", tag="vlp_viewer")


if __name__ == "__main__":
    sys.exit(main())
