"""The port's out-of-core octrees beside the JAX package's on the same numpy
inputs, made from a seed: the flat top-cell store (``OutofcoreOctree``) and
the hierarchical tree (``HierarchicalOutofcoreOctree``).

Tolerances: none. Both packages run the same numpy code and write PCD files
byte for byte alike, so the two trees on disk are equal file for file (node
keys, node files, LOD payloads, metadata), and every query returns the same
rows in the same order.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import os

import numpy as np
import pytest

from pcl_tpu.core.cloud import from_numpy as jfrom
from pcl_tpu.core.cloud import to_numpy as jto
from pcl_tpu.outofcore import HierarchicalOutofcoreOctree as JH
from pcl_tpu.outofcore import OutofcoreOctree as JO

from pcl_tpu_torch.core.cloud import from_numpy, to_numpy
from pcl_tpu_torch.outofcore import HierarchicalOutofcoreOctree as TH
from pcl_tpu_torch.outofcore import OutofcoreOctree as TO


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _batches(rng, n_batches=4, n=3000):
    """Street-like batches: a ground slab and two walls in a 40 x 20 x 6 m box."""
    out = []
    for _ in range(n_batches):
        p = rng.uniform([0, 0, 0], [40, 20, 6], size=(n, 3))
        p[: n // 2, 2] = rng.normal(0.0, 0.02, n // 2)
        p[n // 2: 3 * n // 4, 1] = 1.0
        out.append(p.astype(np.float32))
    return out


def _same_points(tcloud, jcloud):
    a, _ = to_numpy(tcloud)
    b, _ = jto(jcloud)
    np.testing.assert_array_equal(a, b)
    return a


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    rng = np.random.default_rng(30)
    batches = _batches(rng, 3, 2000)
    root = tmp_path_factory.mktemp("ooc")
    t = TO.create(str(root / "t"), cell_size=0.5, origin=(-1.0, -1.0, -1.0), split_depth=4,
                  lod_levels=3, lod_points=256, device="cpu")
    j = JO.create(str(root / "j"), cell_size=0.5, origin=(-1.0, -1.0, -1.0), split_depth=4,
                  lod_levels=3, lod_points=256)
    for b in batches:
        t.add_cloud(from_numpy(b, device="cpu"))
        j.add_cloud(jfrom(b))
    return t, j, np.concatenate(batches)


def test_store_files_match_jax(stores):
    t, j, allp = stores
    assert t.node_keys() == j.node_keys()
    assert t.meta == j.meta and t.meta["n_points"] == len(allp)
    assert _tree_files(t.root) == _tree_files(j.root)
    # the reopened store reads the same metadata
    assert TO(t.root, device="cpu").meta == t.meta


def test_store_nodes_and_lods(stores):
    t, j, allp = stores
    total = 0
    for key in t.node_keys():
        node = _same_points(t.read_node(key), j.read_node(key))
        total += len(node)
        for lv in range(3):
            lod = _same_points(t.read_node(key, lv), j.read_node(key, lv))
            # the LOD rules: min(len, lod_points >> level) rows, at least one,
            # all of them rows of the node
            assert len(lod) == max(1, min(len(node), 256 >> lv))
            assert len(np.unique(lod, axis=0)) == len(lod)        # drawn without replacement
            assert np.isin(lod.view("V12"), node.view("V12")).all()
    assert total == len(allp)


@pytest.mark.parametrize("lod", [None, 0, 2])
def test_store_box_query_matches_jax(stores, lod):
    t, j, allp = stores
    bmin, bmax = (3.2, 2.5, -0.5), (17.9, 11.1, 2.0)
    got = _same_points(t.query_box(bmin, bmax, lod), j.query_box(bmin, bmax, lod))
    assert t.query_box(bmin, bmax).xyz.device.type == "cpu"
    if lod is None:
        inside = ((allp >= bmin) & (allp <= bmax)).all(1)
        key = lambda p: np.lexsort(p.T[::-1])  # noqa: E731
        ref = allp[inside]
        np.testing.assert_array_equal(got[key(got)], ref[key(ref)])
    empty = t.query_box((100, 100, 100), (101, 101, 101), lod)
    assert int(empty.count) == 0


@pytest.mark.parametrize("lod", [None, 1])
def test_store_frustum_query_matches_jax(stores, lod):
    t, j, allp = stores
    # a wedge looking along +x from (0, 10, 1): |y - 10| <= 0.5 x, z <= 3
    planes = np.array([[0.5, -1.0, 0.0, 10.0], [0.5, 1.0, 0.0, -10.0],
                       [0.0, 0.0, -1.0, 3.0], [1.0, 0.0, 0.0, 0.0]])
    got = _same_points(t.query_frustum(planes, lod), j.query_frustum(planes, lod))
    if lod is None:
        inside = (allp.astype(np.float64) @ planes[:, :3].T + planes[:, 3] >= 0).all(1)
        assert len(got) == int(inside.sum())


def test_store_rejects_points_outside(tmp_path):
    t = TO.create(str(tmp_path / "s"), cell_size=1.0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        t.add_cloud(from_numpy(np.array([[-5.0, 0, 0]], np.float32), device="cpu"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    rng = np.random.default_rng(31)
    batches = _batches(rng, 3, 2500)
    batches[1][:40] = [50.0, 0.0, 0.0]                      # outside: dropped
    root = tmp_path_factory.mktemp("hier")
    t = TH.create(str(root / "t"), (0, 0, -1), (40, 20, 7), max_depth=5, points_per_node=400,
                  device="cpu")
    j = JH.create(str(root / "j"), (0, 0, -1), (40, 20, 7), max_depth=5, points_per_node=400)
    accepted = []
    for k, b in enumerate(batches):
        arg_t = from_numpy(b, device="cpu") if k == 0 else b
        arg_j = jfrom(b) if k == 0 else b
        accepted.append((t.add_points(arg_t), j.add_points(arg_j)))
    t.build_lod(seed=3)
    j.build_lod(seed=3)
    return t, j, np.concatenate(batches), accepted


def test_tree_files_match_jax(trees):
    t, j, allp, accepted = trees
    assert all(a == b for a, b in accepted)
    assert sum(a for a, _ in accepted) == len(allp) - 40
    assert _tree_files(t.root) == _tree_files(j.root)
    assert t.tree_stats() == j.tree_stats()
    assert t.tree_stats()["points"] == len(allp) - 40
    assert [os.path.relpath(d, t.root) for d, _ in t.depth_first()] == \
        [os.path.relpath(d, j.root) for d, _ in j.depth_first()]
    bfs = [os.path.relpath(d, t.root) for d, _ in t.breadth_first()]
    assert bfs == [os.path.relpath(d, j.root) for d, _ in j.breadth_first()]
    assert sorted(bfs) == sorted(os.path.relpath(d, t.root) for d, _ in t.depth_first())


@pytest.mark.parametrize("depth", [None, 0, 1, 2, 3])
def test_tree_box_query_matches_jax(trees, depth):
    t, j, allp, _ = trees
    bmin, bmax = (5.5, 3.0, -0.1), (31.0, 15.5, 4.0)
    got = _same_points(t.query_bb_includes(bmin, bmax, depth),
                       j.query_bb_includes(bmin, bmax, depth))
    if depth is None:
        kept = allp[((allp >= (0, 0, -1)) & (allp < (40, 20, 7))).all(1)]
        ref = kept[((kept >= bmin) & (kept <= bmax)).all(1)]
        key = lambda p: np.lexsort(p.T[::-1])  # noqa: E731
        np.testing.assert_array_equal(got[key(got)], ref[key(ref)])


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_tree_voxel_centres_match_jax(trees, depth):
    t, j, _, _ = trees
    np.testing.assert_array_equal(t.get_occupied_voxel_centers(depth),
                                  j.get_occupied_voxel_centers(depth))
