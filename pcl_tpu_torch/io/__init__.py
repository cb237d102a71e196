"""Point-cloud file readers and writers.

Counterpart of ``pcl_tpu/io/__init__.py``: ``load`` and ``save`` dispatch by
extension. ``.pcd``, ``.ply``, ``.xyz`` and ``.txt`` are ported; the other
formats of the JAX package raise until their modules are.
"""

from pcl_tpu_torch.io import lzf
from pcl_tpu_torch.io.pcd import load as load_pcd, save as save_pcd
from pcl_tpu_torch.io.ply import load as load_ply, save as save_ply

__all__ = ["load_pcd", "save_pcd", "load_ply", "save_ply", "lzf", "load", "save"]

# formats the JAX package reads that the port does not yet: extension -> the
# item of ROADMAP.md, queue A, that ports the module
_NOT_PORTED = {".obj": "22 (io/obj.py)", ".ifs": "22 (io/formats_extra.py)",
               ".vtk": "22 (io/formats_extra.py)"}


def _not_ported(path) -> None:
    p = str(path).lower()
    for ext, item in _NOT_PORTED.items():
        if p.endswith(ext):
            raise ValueError(f"{ext} files are not ported yet (ROADMAP.md, queue A, "
                             f"item {item}): {path}")
    raise ValueError(f"unknown point-cloud file extension: {path}")


def load(path, **kw):
    """Read a cloud, the format chosen by the file's extension. ``device=``
    places it (default CUDA)."""
    p = str(path).lower()
    if p.endswith(".pcd"):
        return load_pcd(path, **kw)
    if p.endswith(".ply"):
        return load_ply(path, **kw)
    if p.endswith(".xyz") or p.endswith(".txt"):
        from pcl_tpu_torch.io.ascii import load as load_ascii
        return load_ascii(path, **kw)
    _not_ported(path)


def save(path, cloud, **kw):
    p = str(path).lower()
    if p.endswith(".pcd"):
        return save_pcd(path, cloud, **kw)
    if p.endswith(".ply"):
        return save_ply(path, cloud, **kw)
    if p.endswith(".xyz") or p.endswith(".txt"):
        from pcl_tpu_torch.io.ascii import save as save_ascii
        return save_ascii(path, cloud, **kw)
    _not_ported(path)
