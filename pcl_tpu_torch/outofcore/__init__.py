"""Out-of-core octree — disk-paged storage for clouds larger than memory.

Counterpart of ``pcl_tpu/outofcore`` and of the reference ``outofcore/``
module (reference: outofcore/include/pcl/outofcore/octree_base.h:150,
octree_disk_container.h):
a directory-backed spatial store with per-node PCD payloads, JSON metadata
and random-sampled LOD levels, supporting incremental insertion and boxed /
LOD queries. Node addressing uses the same morton keys as the in-memory
linear octree. ``__all__`` lists the JAX package's names in its order (it
defines none itself).
"""

from pcl_tpu_torch.outofcore.store import OutofcoreOctree
from pcl_tpu_torch.outofcore.hierarchy import HierarchicalOutofcoreOctree

__all__ = ["OutofcoreOctree", "HierarchicalOutofcoreOctree"]
