"""Mesh geometry — half-edge data structure and queries.

Equivalent of the reference's header-only ``geometry/`` module
(geometry/include/pcl/geometry/mesh_base.h, triangle_mesh.h, quad_mesh.h,
polygon_mesh.h + the circulator family). The reference is a pointer-flavored
half-edge template; here the mesh is a struct-of-index-arrays (half-edge
SoA), so every query (one-rings, boundaries, face circulation) is a
vectorized gather over numpy arrays.

Counterpart of ``pcl_tpu/geometry``. Importing this subpackage rebinds the
package attribute ``pcl_tpu_torch.geometry`` (which ``pcl_tpu_torch``
binds to ``core.geometry``) to it, as importing ``pcl_tpu.geometry`` does in
the JAX package (ROADMAP C87).
"""

from pcl_tpu_torch.geometry.halfedge import (
    HalfEdgeMesh,
    build_halfedge_mesh,
    vertex_one_ring,
    vertex_face_ring,
    face_adjacency,
    boundary_half_edges,
    boundary_loops,
    euler_characteristic,
    is_manifold,
    to_face_vertex,
)

__all__ = [
    "HalfEdgeMesh", "build_halfedge_mesh", "vertex_one_ring",
    "vertex_face_ring", "face_adjacency", "boundary_half_edges",
    "boundary_loops", "euler_characteristic", "is_manifold", "to_face_vertex",
]
