"""Multi-device layer on ``torch.distributed`` (counterpart of
``pcl_tpu/parallel``): meshes of ranks, sharded ICP, GICP, NDT, LUM and TSDF,
and the multi-process runtime.

Lazy re-exports (PEP 562), with the JAX package's ``__all__``:
``pcl_tpu_torch.parallel.runtime`` stays importable, and importing this
package creates no process group."""

_LAZY = {
    "make_mesh": "pcl_tpu_torch.parallel.mesh",
    "shard_cloud": "pcl_tpu_torch.parallel.mesh",
    "sharded_icp_step": "pcl_tpu_torch.parallel.icp_sharded",
    "sharded_icp": "pcl_tpu_torch.parallel.icp_sharded",
    "sharded_gicp": "pcl_tpu_torch.parallel.gicp_sharded",
    "sharded_ndt": "pcl_tpu_torch.parallel.ndt_sharded",
    "sharded_lum": "pcl_tpu_torch.parallel.graph_sharded",
}

__all__ = ["make_mesh", "shard_cloud", "sharded_icp_step", "sharded_icp",
           "sharded_gicp", "sharded_ndt", "sharded_lum"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
