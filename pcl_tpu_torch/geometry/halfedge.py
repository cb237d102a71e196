"""Half-edge mesh as index arrays.

Re-design of pcl::geometry::MeshBase / TriangleMesh / PolygonMesh
(reference: geometry/include/pcl/geometry/mesh_base.h — per-element
pointer-style half-edge records; circulators in mesh_circulators.h). The
TPU-idiomatic layout is a struct of int32 arrays:

  he_dst[h]    target vertex of half-edge h
  he_next[h]   next half-edge around its face (boundary halves circulate
               around the hole)
  he_twin[h]   opposite half-edge (always exists: boundary edges get an
               explicit outer half-edge, like the reference)
  he_face[h]   incident face, -1 for boundary halves
  v_he[v]      one outgoing half-edge per vertex (boundary-preferred,
               matching the reference's invariant so boundary circulation
               needs no search)
  f_he[f]      one half-edge per face

Mesh construction is a host-side (numpy) pass — topology building is
sequential bookkeeping, like the reference; queries are vectorized.

Counterpart of ``pcl_tpu/geometry/halfedge.py``: a copy of its numpy code
(host-side, no tensors), so that the half-edge ids, boundary loops and
one-rings come out in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HalfEdgeMesh:
    vertices: np.ndarray      # [V, 3] f32
    he_dst: np.ndarray        # [H] int32
    he_next: np.ndarray       # [H] int32
    he_twin: np.ndarray       # [H] int32
    he_face: np.ndarray       # [H] int32 (-1 = boundary half-edge)
    v_he: np.ndarray          # [V] int32 (-1 = isolated vertex)
    f_he: np.ndarray          # [F] int32
    faces: np.ndarray         # [F, max_arity] int32, -1 padded

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_faces(self) -> int:
        return len(self.f_he)

    @property
    def n_edges(self) -> int:
        return len(self.he_dst) // 2

    def he_src(self, h) -> np.ndarray:
        """Source vertex of half-edge(s) h = dst of the twin."""
        return self.he_dst[self.he_twin[h]]


def build_halfedge_mesh(vertices: np.ndarray, faces) -> HalfEdgeMesh:
    """Build from a face-vertex list (triangles or mixed polygons).

    ``faces``: [F, k] int array (−1 padding allowed) or list of index lists.
    Raises ValueError on non-manifold edges (an edge shared by >2 faces),
    mirroring the reference's addFace failure.
    """
    vertices = np.asarray(vertices, np.float32)
    if isinstance(faces, np.ndarray):
        face_list: List[List[int]] = [
            [int(i) for i in f if i >= 0] for f in faces]
    else:
        face_list = [list(map(int, f)) for f in faces]
    V = len(vertices)
    F = len(face_list)
    max_arity = max((len(f) for f in face_list), default=3)

    # interior half-edges: one per (face, corner)
    he_dst: List[int] = []
    he_next: List[int] = []
    he_face: List[int] = []
    f_he = np.full(F, -1, np.int32)
    edge_map = {}                       # (src, dst) -> half-edge id
    for fi, f in enumerate(face_list):
        k = len(f)
        if k < 3:
            raise ValueError(f"face {fi} has fewer than 3 vertices")
        base = len(he_dst)
        f_he[fi] = base
        for c in range(k):
            src, dst = f[c], f[(c + 1) % k]
            if (src, dst) in edge_map:
                raise ValueError(
                    f"non-manifold or inconsistently wound edge ({src},{dst})")
            edge_map[(src, dst)] = base + c
            he_dst.append(dst)
            he_next.append(base + (c + 1) % k)
            he_face.append(fi)

    # twins; missing twins become boundary half-edges
    H_in = len(he_dst)
    he_twin = np.full(H_in, -1, np.int64)
    boundary_src_dst: List[Tuple[int, int]] = []
    for (src, dst), h in edge_map.items():
        t = edge_map.get((dst, src))
        if t is not None:
            he_twin[h] = t
        else:
            boundary_src_dst.append((dst, src))    # outer half runs dst->src

    he_dst = np.asarray(he_dst, np.int64)
    he_next = np.asarray(he_next, np.int64)
    he_face = np.asarray(he_face, np.int64)
    nb = len(boundary_src_dst)
    if nb:
        b_dst = np.asarray([d for _, d in boundary_src_dst], np.int64)
        b_src = np.asarray([s for s, _ in boundary_src_dst], np.int64)
        b_ids = H_in + np.arange(nb)
        # twin pairing: boundary half (src=dst_int, dst=src_int)
        he_dst = np.concatenate([he_dst, b_dst])
        he_face = np.concatenate([he_face, np.full(nb, -1, np.int64)])
        he_twin = np.concatenate([he_twin, np.full(nb, -1, np.int64)])
        for bi, (s, d) in enumerate(boundary_src_dst):
            inner = edge_map[(d, s)]
            he_twin[inner] = b_ids[bi]
            he_twin[b_ids[bi]] = inner
        # next around the hole: boundary half h ends at vertex he_dst[h];
        # its successor is the boundary half STARTING there
        start_of = {int(s): int(b_ids[i]) for i, (s, _) in enumerate(boundary_src_dst)}
        b_next = np.asarray([start_of[int(d)] for d in b_dst], np.int64)
        he_next = np.concatenate([he_next, b_next])

    # outgoing half-edge per vertex, boundary-preferred
    v_he = np.full(V, -1, np.int64)
    src_all = he_dst[he_twin]
    for h in range(len(he_dst)):
        s = int(src_all[h])
        if v_he[s] < 0 or (he_face[h] < 0 and he_face[v_he[s]] >= 0):
            v_he[s] = h

    faces_arr = np.full((F, max_arity), -1, np.int32)
    for fi, f in enumerate(face_list):
        faces_arr[fi, :len(f)] = f

    return HalfEdgeMesh(
        vertices=vertices,
        he_dst=he_dst.astype(np.int32),
        he_next=he_next.astype(np.int32),
        he_twin=he_twin.astype(np.int32),
        he_face=he_face.astype(np.int32),
        v_he=v_he.astype(np.int32),
        f_he=f_he.astype(np.int32),
        faces=faces_arr,
    )


def vertex_one_ring(mesh: HalfEdgeMesh, v: int, max_ring: int = 64) -> np.ndarray:
    """Neighbor vertices around v in order (reference:
    VertexAroundVertexCirculator)."""
    h0 = int(mesh.v_he[v])
    if h0 < 0:
        return np.zeros((0,), np.int32)
    out = []
    h = h0
    for _ in range(max_ring):
        out.append(int(mesh.he_dst[h]))
        h = int(mesh.he_next[mesh.he_twin[h]])   # rotate clockwise around v
        if h == h0:
            break
    return np.asarray(out, np.int32)


def vertex_face_ring(mesh: HalfEdgeMesh, v: int, max_ring: int = 64) -> np.ndarray:
    """Faces incident to v in order (FaceAroundVertexCirculator)."""
    h0 = int(mesh.v_he[v])
    if h0 < 0:
        return np.zeros((0,), np.int32)
    out = []
    h = h0
    for _ in range(max_ring):
        f = int(mesh.he_face[h])
        if f >= 0:
            out.append(f)
        h = int(mesh.he_next[mesh.he_twin[h]])
        if h == h0:
            break
    return np.asarray(out, np.int32)


def face_adjacency(mesh: HalfEdgeMesh) -> np.ndarray:
    """[F, max_arity] neighbor face per edge (-1 at boundaries)
    (FaceAroundFaceCirculator, vectorized for all faces)."""
    F, A = mesh.faces.shape
    out = np.full((F, A), -1, np.int32)
    for fi in range(F):
        h = int(mesh.f_he[fi])
        k = int((mesh.faces[fi] >= 0).sum())
        for c in range(k):
            out[fi, c] = mesh.he_face[mesh.he_twin[h]]
            h = int(mesh.he_next[h])
    return out


def boundary_half_edges(mesh: HalfEdgeMesh) -> np.ndarray:
    """Indices of the boundary (face-less) half-edges."""
    return np.nonzero(mesh.he_face < 0)[0].astype(np.int32)


def boundary_loops(mesh: HalfEdgeMesh) -> List[np.ndarray]:
    """Boundary loops as ordered vertex index arrays."""
    bset = set(boundary_half_edges(mesh).tolist())
    loops = []
    while bset:
        h0 = next(iter(bset))
        loop = []
        h = h0
        while True:
            bset.discard(h)
            loop.append(int(mesh.he_dst[h]))
            h = int(mesh.he_next[h])
            if h == h0:
                break
        loops.append(np.asarray(loop, np.int32))
    return loops


def euler_characteristic(mesh: HalfEdgeMesh) -> int:
    """V - E + F."""
    return mesh.n_vertices - mesh.n_edges + mesh.n_faces


def is_manifold(mesh: HalfEdgeMesh) -> bool:
    """Every vertex's incident half-edges form one fan (reference:
    MeshBase::isManifold). Construction already rejects non-manifold edges;
    this additionally detects 'bowtie' vertices."""
    V = mesh.n_vertices
    # count incident outgoing half-edges per vertex
    src = mesh.he_dst[mesh.he_twin]
    deg = np.bincount(src, minlength=V)
    for v in range(V):
        if mesh.v_he[v] < 0:
            continue
        ring = vertex_one_ring(mesh, v, max_ring=int(deg[v]) + 1)
        if len(ring) != deg[v]:
            return False
    return True


def to_face_vertex(mesh: HalfEdgeMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Back to (vertices, faces) arrays (reference: toFaceVertexMesh)."""
    return mesh.vertices, mesh.faces
