"""Point-cloud file readers and writers.

Counterpart of ``pcl_tpu/io/__init__.py``: ``load`` and ``save`` dispatch by
extension (``.pcd``, ``.ply``, ``.xyz``/``.txt``, ``.obj``, ``.ifs``,
``.vtk``). As in the JAX package, saving an ``.obj`` path imports a writer
that ``io/obj.py`` does not define, and raises ``ImportError`` (ROADMAP
C86); ``tools/ply2obj.py`` writes OBJ text itself.
"""

from pcl_tpu_torch.io import lzf
from pcl_tpu_torch.io.pcd import load as load_pcd, save as save_pcd
from pcl_tpu_torch.io.ply import load as load_ply, save as save_ply

__all__ = ["load_pcd", "save_pcd", "load_ply", "save_ply", "lzf", "load", "save"]


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
    if p.endswith(".obj"):
        from pcl_tpu_torch.io.obj import load as load_obj
        return load_obj(path, **kw)
    if p.endswith(".ifs"):
        from pcl_tpu_torch.io.formats_extra import load_ifs_cloud
        return load_ifs_cloud(path, device=kw.get("device"))
    if p.endswith(".vtk"):
        from pcl_tpu_torch.io.formats_extra import load_vtk_cloud
        return load_vtk_cloud(path, device=kw.get("device"))
    raise ValueError(f"unknown point-cloud file extension: {path}")


def save(path, cloud, **kw):
    p = str(path).lower()
    if p.endswith(".pcd"):
        return save_pcd(path, cloud, **kw)
    if p.endswith(".ply"):
        return save_ply(path, cloud, **kw)
    if p.endswith(".xyz") or p.endswith(".txt"):
        from pcl_tpu_torch.io.ascii import save as save_ascii
        return save_ascii(path, cloud, **kw)
    if p.endswith(".vtk") or p.endswith(".ifs"):
        from pcl_tpu_torch.core.cloud import to_numpy
        from pcl_tpu_torch.io import formats_extra

        xyz, _ = to_numpy(cloud)
        write = formats_extra.save_vtk if p.endswith(".vtk") else formats_extra.save_ifs
        return write(path, xyz, **kw)
    if p.endswith(".obj"):
        from pcl_tpu_torch.io.obj import save as save_obj  # noqa: F401  (C86: raises)
        return save_obj(path, cloud, **kw)
    raise ValueError(f"unknown point-cloud file extension: {path}")
