"""CLI: xyz2pcd converter (counterpart of ``pcl_tpu/tools/xyz2pcd.py``;
reference: tools/xyz2pcd.cpp) — delegates to the extension-dispatching
converter, ``tools.convert``.

    python -m pcl_tpu_torch.tools.xyz2pcd in.xyz out.pcd [--ascii] [--device cpu]
"""
import sys

from pcl_tpu_torch.tools.convert import main as _convert_main


def main(argv=None):
    return _convert_main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
