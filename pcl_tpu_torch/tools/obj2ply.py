"""CLI: obj2ply converter (counterpart of ``pcl_tpu/tools/obj2ply.py``;
reference: tools/obj2ply.cpp) — delegates to the extension-dispatching
converter, ``tools.convert``.

    python -m pcl_tpu_torch.tools.obj2ply in.obj out.ply [--ascii] [--device cpu]
"""
import sys

from pcl_tpu_torch.tools.convert import main as _convert_main


def main(argv=None):
    return _convert_main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
