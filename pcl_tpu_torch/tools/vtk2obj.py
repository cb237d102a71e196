"""CLI: vtk2obj converter (counterpart of ``pcl_tpu/tools/vtk2obj.py``;
reference: tools/vtk2obj.cpp) — delegates to the extension-dispatching
converter, ``tools.convert``. As in the JAX package, ``io.save`` has no
OBJ writer, so the conversion raises ``ImportError`` (ROADMAP C86);
``tools.ply2obj`` writes OBJ files.

    python -m pcl_tpu_torch.tools.vtk2obj in.vtk out.obj [--ascii] [--device cpu]
"""
import sys

from pcl_tpu_torch.tools.convert import main as _convert_main


def main(argv=None):
    return _convert_main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
