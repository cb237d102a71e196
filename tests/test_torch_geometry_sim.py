"""Parity of the port's half-edge meshes and depth simulation with the JAX
package on the CPU.

Tolerances:
- ``geometry``: host numpy in both, so every array is equal bit for bit —
  half-edge ids, twins, boundary loops and one-rings in their order — on
  closed (a box, an icosahedron), open (a sheet with holes) and mixed
  polygon meshes; both raise on a non-manifold edge and both call a bowtie
  vertex non-manifold.
- ``render_depth``: equal bit for bit on every pixel that no point within
  1e-4 px of a pixel's half-way line can reach (the two packages' inverse
  and ``[N,3] @ [3,3]`` round such a projection apart, ROADMAP C27, C92).
- ``range_likelihood``: to 1e-5 of the sum of its terms' magnitudes (a
  float32 sum over the pixels of terms of both signs, added in another
  order); the best of a grid of candidate poses equal.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pcl_tpu import simulation as jsim
from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.fusion.tsdf import Intrinsics as JIntr

from pcl_tpu_torch import simulation as tsim
from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.fusion import Intrinsics

# ``from <package> import geometry`` gives ``core.geometry`` until the
# subpackage is imported, in both packages (ROADMAP C87)
import pcl_tpu.geometry as jgeo  # noqa: E402
import pcl_tpu_torch.geometry as tgeo  # noqa: E402


def _box():
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    return v, np.array(tris, np.int32)


def _icosahedron():
    p = (1 + 5 ** 0.5) / 2
    v = np.array([(-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p), (0, 1, p),
                  (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1)],
                 np.float32)
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
         (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
         (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    return v, np.array(f, np.int32)


def _sheet(h=9, w=12, holes=((3, 4), (5, 8), (6, 2))):
    """An organized sheet's two triangles a quad, less the quads at
    ``holes``: an open mesh with interior boundary loops."""
    v = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2)
    v = np.concatenate([v, np.zeros((len(v), 1))], 1).astype(np.float32)
    tris = []
    for r in range(h - 1):
        for c in range(w - 1):
            if (r, c) in holes:
                continue
            a, b, cc, d = r * w + c, r * w + c + 1, (r + 1) * w + c, (r + 1) * w + c + 1
            tris += [(a, cc, b), (b, cc, d)]
    return v, np.array(tris, np.int32)


def _mixed():
    """Two quads and a pentagon sharing edges, as lists (``-1`` padded as an
    array too)."""
    v = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    return v, [[0, 1, 2, 3], [1, 4, 5, 2], [2, 5, 6, 7, 3]]


MESHES = {"box": _box, "icosahedron": _icosahedron, "sheet": _sheet, "mixed": _mixed}


def _same_mesh(a, b):
    for f in ("vertices", "he_dst", "he_next", "he_twin", "he_face", "v_he", "f_he", "faces"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name", list(MESHES))
def test_halfedge_mesh_matches_jax(name):
    v, f = MESHES[name]()
    tm, jm = tgeo.build_halfedge_mesh(v, f), jgeo.build_halfedge_mesh(v, f)
    _same_mesh(tm, jm)
    assert (tm.n_vertices, tm.n_edges, tm.n_faces) == (jm.n_vertices, jm.n_edges, jm.n_faces)
    assert tgeo.euler_characteristic(tm) == jgeo.euler_characteristic(jm)
    if name in ("box", "icosahedron"):
        assert tgeo.euler_characteristic(tm) == 2 and len(tgeo.boundary_loops(tm)) == 0
    assert tgeo.is_manifold(tm) == jgeo.is_manifold(jm) is True
    np.testing.assert_array_equal(tgeo.boundary_half_edges(tm), jgeo.boundary_half_edges(jm))
    for a, b in zip(tgeo.boundary_loops(tm), jgeo.boundary_loops(jm), strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgeo.face_adjacency(tm), jgeo.face_adjacency(jm))
    for vi in range(tm.n_vertices):
        np.testing.assert_array_equal(tgeo.vertex_one_ring(tm, vi), jgeo.vertex_one_ring(jm, vi))
        np.testing.assert_array_equal(tgeo.vertex_face_ring(tm, vi),
                                      jgeo.vertex_face_ring(jm, vi))
    np.testing.assert_array_equal(tm.he_src(np.arange(len(tm.he_dst))),
                                  jm.he_src(np.arange(len(jm.he_dst))))
    for a, b in zip(tgeo.to_face_vertex(tm), jgeo.to_face_vertex(jm)):
        np.testing.assert_array_equal(a, b)


def test_sheet_boundary_loops_count_the_boundary_edges():
    v, f = _sheet()
    m = tgeo.build_halfedge_mesh(v, f)
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), 1)
    _, count = np.unique(edges, axis=0, return_counts=True)
    loops = tgeo.boundary_loops(m)
    assert len(loops) == 4 and sum(len(x) for x in loops) == (count == 1).sum()
    assert tgeo.euler_characteristic(m) == 2 - len(loops)


def test_non_manifold_meshes_alike():
    v, f = _box()
    bad = np.concatenate([f, [[0, 1, 3]]])           # an edge on three faces
    for mod in (tgeo, jgeo):
        with pytest.raises(ValueError, match="non-manifold"):
            mod.build_halfedge_mesh(v, bad)
        with pytest.raises(ValueError, match="fewer than 3"):
            mod.build_halfedge_mesh(v, [[0, 1]])
    # a bowtie: two triangles meeting at one vertex
    bv = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    bt = np.array([[0, 1, 2], [0, 3, 4]], np.int32)
    tm, jm = tgeo.build_halfedge_mesh(bv, bt), jgeo.build_halfedge_mesh(bv, bt)
    _same_mesh(tm, jm)
    assert tgeo.is_manifold(tm) is jgeo.is_manifold(jm) is False


H, W = 48, 64
INTR = (60.0, 60.0, 31.5, 23.5)


def _scene_points(seed=0, n=6000):
    rng = np.random.default_rng(seed)
    wall = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 4.0)], 1)
    box = np.stack([rng.uniform(-0.5, 0.5, n // 3), rng.uniform(-0.4, 0.6, n // 3),
                    rng.uniform(2.0, 2.5, n // 3)], 1)
    return np.concatenate([wall, box]).astype(np.float32)


def _pose(x=0.0, z=0.0, yaw=0.0):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_euler("y", yaw, degrees=True).as_matrix()
    T[:3, 3] = (x, 0.0, z)
    return T


def _reachable_near_half(xyz, pose):
    """Pixels that a point projecting within 1e-4 px of a half-way line
    could round to, by a float64 projection."""
    w2c = np.linalg.inv(pose.astype(np.float64))
    p = xyz.astype(np.float64) @ w2c[:3, :3].T + w2c[:3, 3]
    fx, fy, cx, cy = INTR
    u = fx * p[:, 0] / p[:, 2] + cx
    v = fy * p[:, 1] / p[:, 2] + cy
    near = (np.abs(u - np.floor(u) - 0.5) < 1e-4) | (np.abs(v - np.floor(v) - 0.5) < 1e-4)
    out = np.zeros((H, W), bool)
    for uu in (np.floor(u[near]), np.ceil(u[near])):
        for vv in (np.floor(v[near]), np.ceil(v[near])):
            ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            out[vv[ok].astype(int), uu[ok].astype(int)] = True
    return out


@pytest.mark.parametrize("pose", [(0, 0, 0), (0.1, -0.2, 5.0), (-0.3, 0.4, -12.0)])
def test_render_depth_matches_jax(pose):
    xyz = _scene_points()
    mask = np.ones(len(xyz), bool)
    mask[::7] = False
    T = _pose(*pose)
    want = np.asarray(jsim.render_depth(jmake(jnp.asarray(xyz), jnp.asarray(mask)),
                                        jnp.asarray(T), JIntr(*INTR), H, W))
    got = tsim.render_depth(make_cloud(xyz, mask, device="cpu"), torch.from_numpy(T),
                            Intrinsics(*INTR), H, W).numpy()
    near = _reachable_near_half(xyz[mask], T)
    np.testing.assert_array_equal(got[~near], want[~near])
    assert (got > 0).mean() > 0.3 and near.mean() < 0.01


def test_range_likelihood_matches_jax_and_picks_the_true_pose():
    xyz = _scene_points(1)
    rng = np.random.default_rng(2)
    tc, jc = make_cloud(xyz, device="cpu"), jmake(jnp.asarray(xyz))
    obs = tsim.render_depth(tc, torch.eye(4), Intrinsics(*INTR), H, W).numpy()
    obs = np.where(rng.random(obs.shape) < 0.05, 0.0, obs + rng.normal(
        scale=0.005, size=obs.shape) * (obs > 0)).astype(np.float32)
    cands = [(x, z, yaw) for x in (-0.04, 0.0, 0.04) for z in (-0.04, 0.0, 0.04)
             for yaw in (-1.0, 0.0, 1.0)]
    for kw in (dict(), dict(sigma=0.02, outlier_prob=0.2, max_range=8.0)):
        lt, lj, scale = [], [], []
        for c in cands:
            T = _pose(*c)
            rt = tsim.render_depth(tc, torch.from_numpy(T), Intrinsics(*INTR), H, W)
            rj = jsim.render_depth(jc, jnp.asarray(T), JIntr(*INTR), H, W)
            lt.append(float(tsim.range_likelihood(rt, torch.from_numpy(obs), **kw)))
            lj.append(float(jsim.range_likelihood(rj, jnp.asarray(obs), **kw)))
            scale.append(_abs_terms(rt.numpy(), obs, **kw))
        np.testing.assert_array_less(np.abs(np.subtract(lt, lj)), 1e-5 * np.array(scale))
        assert int(np.argmax(lt)) == int(np.argmax(lj)) == cands.index((0.0, 0.0, 0.0))


def _abs_terms(rendered, observed, sigma=0.05, outlier_prob=0.1, max_range=5.0):
    """The sum of the per-pixel terms' magnitudes, in float64: the scale of
    the likelihood's rounding (its terms have both signs)."""
    both = (rendered > 0) & (observed > 0)
    d = rendered.astype(np.float64) - observed
    mix = ((1 - outlier_prob) * np.exp(-0.5 * (d / sigma) ** 2) / (sigma * 2.5066283)
           + outlier_prob / max_range)
    return float(np.abs(np.where(both, np.log(np.maximum(mix, 1e-12)), 0.0)).sum())
