"""The linear octree of pcl_tpu_torch against the JAX package's on the CPU.

Both packages get the same numpy inputs; the query functions also get the
same tree (``interop.linear_octree_from_arrays`` of the JAX package's).
Keys, orders, masks, leaf counts, voxel and box searches, change masks,
adjacency, occupancy, rays, approximate neighbours, XOR streams and
iterator nodes are equal; centroids agree within 1e-6 of the coordinates'
scale (the sums are added in another order). The casts of ``floor((p -
origin) / res)`` give what XLA's give for NaN and for points at +-3e9 (XLA
saturates, torch gives INT_MIN: ROADMAP C71).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pcl_tpu import octree as joc
from pcl_tpu.octree import containers as jcont
from pcl_tpu.octree import iterators as jit_
from pcl_tpu.octree.double_buffer import DoubleBufferedOctree as JDouble

from pcl_tpu_torch import interop
from pcl_tpu_torch import octree as toc
from pcl_tpu_torch.octree import containers as tcont
from pcl_tpu_torch.octree import iterators as tit
from pcl_tpu_torch.octree import linear as tlin
from pcl_tpu_torch.octree.double_buffer import DoubleBufferedOctree as TDouble

CPU = torch.device("cpu")
RES = 0.25


def _scene(seed=0, n=3000):
    """Clusters of points (several a leaf), a few far ones, 5% invalid."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-6, 6, size=(60, 3))
    pts = centres[rng.integers(0, 60, n)] + rng.normal(scale=0.3, size=(n, 3))
    pts[:20] = rng.uniform(-40, 40, size=(20, 3))
    mask = rng.uniform(size=n) > 0.05
    return pts.astype(np.float32), mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_tree(jtree):
    return interop.linear_octree_from_arrays(
        np.asarray(jtree.origin), float(jtree.resolution), jtree.depth, np.asarray(jtree.keys),
        np.asarray(jtree.order), np.asarray(jtree.mask), device="cpu")


@pytest.fixture(scope="module")
def scene():
    pts, mask = _scene()
    jtree = joc.build(jnp.asarray(pts), jnp.asarray(mask), RES)
    return pts, mask, jtree, _port_tree(jtree)


def _assert_tree_equal(ttree, jtree):
    for name in ("keys", "order", "mask", "origin"):
        np.testing.assert_array_equal(_np(getattr(ttree, name)), np.asarray(getattr(jtree, name)),
                                      err_msg=name)
    assert ttree.depth == jtree.depth
    assert int(ttree.leaf_count) == int(jtree.leaf_count)


def test_morton_decode_matches_jax():
    cells = np.random.default_rng(1).integers(0, 1024, size=(500, 3)).astype(np.int32)
    keys = tlin.morton_encode(_t(cells))
    np.testing.assert_array_equal(_np(keys), np.asarray(joc.morton_encode(jnp.asarray(cells))))
    np.testing.assert_array_equal(_np(toc.morton_decode(keys)), cells)
    np.testing.assert_array_equal(_np(toc.morton_decode(keys)),
                                  np.asarray(joc.morton_decode(jnp.asarray(_np(keys)))))


@pytest.mark.parametrize("origin,depth", [(None, 10), ((-8.0, -8.0, -8.0), 10),
                                          ((0.0, 0.0, 0.0), 6)])
def test_build_matches_jax(scene, origin, depth):
    """Sorted keys, the stable order within a leaf, the mask and the origin
    are equal, for the clouds' own corner and a given one (points below a
    given corner clip to cell 0)."""
    pts, mask, _, _ = scene
    j_o = None if origin is None else jnp.asarray(origin, jnp.float32)
    t_o = None if origin is None else _t(np.asarray(origin, np.float32))
    jtree = joc.build(jnp.asarray(pts), jnp.asarray(mask), RES, origin=j_o, depth=depth)
    _assert_tree_equal(toc.build(_t(pts), _t(mask), RES, origin=t_o, depth=depth), jtree)


@pytest.mark.parametrize("given_origin", [False, True])
def test_build_casts_as_xla_at_nan_and_3e9(given_origin):
    """Points at +-3e9 and NaN that the mask calls valid: XLA's cast
    saturates to the top cell and takes NaN to 0 before the clip; so does
    the port (C71). Without a given origin the minimum is NaN, taken to 0 in
    both."""
    pts, mask = _scene(2, 200)
    pts[:6] = [[3e9, 0, 0], [-3e9, 1, 1], [np.nan, 0, 0], [0, np.nan, 2], [1e20, -1e20, 0],
               [2, 3e9, -3e9]]
    mask[:6] = True
    j_o = jnp.zeros(3) if given_origin else None
    t_o = torch.zeros(3) if given_origin else None
    jtree = joc.build(jnp.asarray(pts), jnp.asarray(mask), RES, origin=j_o)
    ttree = toc.build(_t(pts), _t(mask), RES, origin=t_o)
    _assert_tree_equal(ttree, jtree)
    # the queries cast the same way
    q = pts[:6]
    np.testing.assert_array_equal(_np(toc.is_voxel_occupied(ttree, _t(q))),
                                  np.asarray(joc.is_voxel_occupied(jtree, jnp.asarray(q))))
    np.testing.assert_array_equal(_np(tlin._key_of_points(ttree, _t(q))),
                                  np.asarray(joc.linear._key_of_points(jtree, jnp.asarray(q))))


def test_queries_match_jax(scene):
    """is_voxel_occupied, voxel_search (a cap below the fullest leaf), at_depth
    at every level, on the same tree."""
    pts, mask, jtree, ttree = scene
    q = np.concatenate([pts[::7], pts[::11] + np.float32(0.13), pts[:5] + 100])
    np.testing.assert_array_equal(_np(toc.is_voxel_occupied(ttree, _t(q))),
                                  np.asarray(joc.is_voxel_occupied(jtree, jnp.asarray(q))))
    for cap in (4, 32):
        ti, tv = toc.voxel_search(ttree, _t(q), cap=cap)
        ji, jv = joc.voxel_search(jtree, jnp.asarray(q), cap=cap)
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    for level in range(jtree.depth + 1):
        tk, tf = toc.at_depth(ttree, level)
        jk, jf = joc.at_depth(jtree, level)
        np.testing.assert_array_equal(_np(tk), np.asarray(jk))
        np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    with pytest.raises(ValueError):
        toc.at_depth(ttree, jtree.depth + 1)


def test_leaf_centroids_match_jax(scene):
    """Counts and the leaf count exact; centroids within 1e-6 of the
    coordinates' scale."""
    pts, mask, jtree, ttree = scene
    tc, tn, tl = toc.leaf_centroids(ttree, _t(pts))
    jc, jn, jl = joc.leaf_centroids(jtree, jnp.asarray(pts))
    assert int(tl) == int(jl)
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    scale = float(np.abs(pts[mask]).max())
    assert np.abs(_np(tc) - np.asarray(jc)).max() <= 1e-6 * scale


def test_change_detection_and_box_search_match_jax(scene):
    """Two trees with one origin (C72); a box whose count exceeds the cap."""
    pts, mask, jtree, ttree = scene
    rng = np.random.default_rng(3)
    moved = pts + rng.normal(scale=0.2, size=pts.shape).astype(np.float32)
    moved[::5] += np.float32(3.0)
    jnow = joc.build(jnp.asarray(moved), jnp.asarray(mask), RES, origin=jtree.origin)
    tnow = toc.build(_t(moved), _t(mask), RES, origin=ttree.origin)
    _assert_tree_equal(tnow, jnow)
    np.testing.assert_array_equal(_np(toc.change_detection(tnow, ttree)),
                                  np.asarray(joc.change_detection(jnow, jtree)))
    for lo, hi, cap in (((-3, -3, -3), (3, 3, 3), 64), ((-3, -3, -3), (3, 3, 3), 4096),
                        ((50, 50, 50), (60, 60, 60), 16)):
        ti, tv, tn = toc.box_search(ttree, _t(np.float32(lo)), _t(np.float32(hi)), _t(pts),
                                    cap=cap)
        ji, jv, jn = joc.box_search(jtree, jnp.asarray(lo, jnp.float32),
                                    jnp.asarray(hi, jnp.float32), jnp.asarray(pts), cap=cap)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))


def test_rays_and_approx_nearest_match_jax(scene):
    """Rays from outside and inside the box (truncating casts, C73), and the
    approximate 1-NN of moved points, on the same tree: equal."""
    pts, mask, jtree, ttree = scene
    rng = np.random.default_rng(4)
    ends = pts[rng.choice(np.flatnonzero(mask), 96, replace=False)]
    starts = np.concatenate([np.zeros((48, 3)), np.full((48, 3), -45.0)]).astype(np.float32)
    d = ends - starts
    rng_ = np.linalg.norm(d, axis=1)
    d = (d / rng_[:, None]).astype(np.float32)
    reach = float(rng_.max()) + 1.0
    steps = int(np.ceil(reach / (RES / 2))) + 2
    tk, tv = toc.ray_intersected_voxels(ttree, _t(starts), _t(d), reach, max_steps=steps)
    jk, jv = joc.ray_intersected_voxels(jtree, jnp.asarray(starts), jnp.asarray(d), reach,
                                        max_steps=steps)
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    assert _np(tv).any(axis=1).mean() > 0.9
    sorted_xyz = pts[np.asarray(jtree.order)]
    q = (pts[::3] + rng.normal(scale=0.15, size=pts[::3].shape)).astype(np.float32)
    q[:4] = [[np.nan, 0, 0], [3e9, 0, 0], [-3e9, 0, 0], [-100, 0, 0]]
    ti, td = toc.approx_nearest_search(ttree, _t(sorted_xyz), _t(q))
    ji, jd = joc.approx_nearest_search(jtree, jnp.asarray(sorted_xyz), jnp.asarray(q))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(td), np.asarray(jd))


def test_containers_match_jax(scene):
    """leaf_keys, the [L, 26] adjacency table, the occupancy grid and an
    insert that grows it, with NaN and +-3e9 among the queries and the
    inserts (C71)."""
    pts, mask, jtree, ttree = scene
    for tout, jout in zip(tcont.leaf_keys(ttree), jcont.leaf_keys(jtree)):
        np.testing.assert_array_equal(_np(tout), np.asarray(jout))
    for tout, jout in zip(toc.adjacency(ttree), joc.adjacency(jtree)):
        np.testing.assert_array_equal(_np(tout), np.asarray(jout))
    tg, jg = toc.occupancy_from_tree(ttree), joc.occupancy_from_tree(jtree)
    np.testing.assert_array_equal(_np(tg.keys), np.asarray(jg.keys))
    assert int(tg.n_occupied) == int(jg.n_occupied)
    rng = np.random.default_rng(5)
    new = rng.uniform(-10, 10, size=(300, 3)).astype(np.float32)
    new[:4] = [[np.nan, 1, 1], [3e9, 0, 0], [-3e9, 0, 0], [0, 0, 1e20]]
    nmask = rng.uniform(size=300) > 0.1
    nmask[:4] = True
    np.testing.assert_array_equal(_np(toc.is_occupied(tg, _t(new))),
                                  np.asarray(joc.is_occupied(jg, jnp.asarray(new))))
    # the same grid handed over from the JAX package's arrays
    tg_j = interop.occupancy_grid_from_arrays(np.asarray(jg.keys), int(jg.n_occupied),
                                              np.asarray(jg.origin), float(jg.resolution),
                                              jg.depth, device="cpu")
    for grid in (tg, tg_j):
        t2 = toc.set_occupied(grid, _t(new), _t(nmask))
        j2 = joc.set_occupied(jg, jnp.asarray(new), jnp.asarray(nmask))
        assert t2.keys.shape[0] == len(pts) + len(new)
        np.testing.assert_array_equal(_np(t2.keys), np.asarray(j2.keys))
        assert int(t2.n_occupied) == int(j2.n_occupied)
        np.testing.assert_array_equal(_np(toc.is_occupied(t2, _t(new))),
                                      np.asarray(joc.is_occupied(j2, jnp.asarray(new))))


def test_double_buffer_matches_jax():
    """Three frames through both double buffers: new and removed leaves, the
    new points' indices, the bitmaps and the XOR stream; the origin pinned at
    the first frame (C72)."""
    rng = np.random.default_rng(6)
    frames = []
    base, m = _scene(7, 1500)
    for k in range(3):
        f = base + np.float32(0.4 * k)
        f[rng.choice(len(f), 100, replace=False)] += np.float32(5.0)
        frames.append(f.astype(np.float32))
    td, jd = TDouble(resolution=0.3, device="cpu"), JDouble(resolution=0.3)
    assert len(td.new_leaf_keys()) == 0 and len(td.removed_leaf_keys()) == 0
    for k, f in enumerate(frames):
        if k:
            td.switch_buffers()
            jd.switch_buffers()
        td.set_cloud(f, m)
        jd.set_cloud(f, m)
        np.testing.assert_array_equal(td.origin, jd.origin)
        np.testing.assert_array_equal(td.new_leaf_keys(), jd.new_leaf_keys())
        np.testing.assert_array_equal(td.removed_leaf_keys(), jd.removed_leaf_keys())
        np.testing.assert_array_equal(td.new_point_indices(), jd.new_point_indices())
        for which in ("current", "previous"):
            np.testing.assert_array_equal(td.occupancy_bitmap(which), jd.occupancy_bitmap(which))
        diff = td.xor_serialize()
        np.testing.assert_array_equal(diff, jd.xor_serialize())
        np.testing.assert_array_equal(td.xor_apply(td.occupancy_bitmap("previous"), diff),
                                      td.occupancy_bitmap("current"))
    # tensors stay on their device
    td.set_cloud(_t(frames[0]), _t(m))
    assert td.current.keys.device == CPU


def test_iterators_match_jax():
    """Every iterator's nodes, in order and count, and the per-depth counts,
    on a depth-5 tree."""
    pts, mask = _scene(8, 800)
    jtree = joc.build(jnp.asarray(pts), jnp.asarray(mask), 0.6, depth=5)
    ttree = _port_tree(jtree)
    for name in ("leaf_iterator", "depth_first_iterator", "breadth_first_iterator",
                 "leaf_breadth_first_iterator"):
        assert list(getattr(tit, name)(ttree)) == list(getattr(jit_, name)(jtree)), name
    for d in range(6):
        assert list(tit.fixed_depth_iterator(ttree, d)) == list(jit_.fixed_depth_iterator(jtree, d))
    counts = tit.node_counts_per_depth(ttree)
    assert counts == jit_.node_counts_per_depth(jtree)
    assert len(list(tit.depth_first_iterator(ttree))) == sum(counts)
    with pytest.raises(ValueError):
        list(tit.fixed_depth_iterator(ttree, 6))
    empty = toc.build(torch.zeros((4, 3)), torch.zeros(4, dtype=torch.bool), 0.5, depth=3)
    assert list(tit.depth_first_iterator(empty)) == []
    assert list(tit.breadth_first_iterator(empty)) == []
