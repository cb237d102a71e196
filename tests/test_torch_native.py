"""The port's native host runtime (``pcl_tpu_torch.native``: kd-tree, Morton
keys, voxel centroids over ``csrc/pcl_native.cpp``) against the JAX
package's (``pcl_tpu.native``) and against its own numpy fallbacks, as
``tests/test_native.py`` tests the JAX side.

- The library under test is the port's build of its own source, under
  ``build/kernels/``; nothing of the JAX package's tree is loaded or read.
- Both packages compile the same algorithm with the same compiler, so every
  result is the JAX package's bit for bit, ties and unstable orders too.
- Against the fallbacks (ROADMAP C99-C101): k-NN and radius distances to
  float32 rounding (1e-6) and indices whose distances are those; the Morton
  argsort equal where the codes are distinct and elsewhere an order that
  sorts them (``std::sort`` is not stable); codes within one step of the
  fallback's on each axis (a float32 product against the fallback's
  quotient); voxel centroids to 1e-6 on the minimum-relative grid, which is
  not ``voxel_downsample``'s absolute grid.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import pathlib

import numpy as np
import pytest
import torch

from pcl_tpu import native as jn

from pcl_tpu_torch import native as tn
from pcl_tpu_torch.filters import voxel_downsample
from pcl_tpu_torch.core.cloud import from_numpy
from pcl_tpu_torch.ops import _build

PORT = pathlib.Path(tn.__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(3)
    return rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(4)
    return rng.uniform(-1.1, 1.1, size=(300, 3)).astype(np.float32)


def test_the_ports_own_build_is_under_test():
    """The library runs where a C++ compiler is found, built from the port's source
    into ``build/kernels/`` under a name keyed by the source's digest; no
    file of the port names the JAX package's native directory."""
    assert tn.available()
    path = pathlib.Path(_build.host_library("pcl_native")._name)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("pcl_native-")
    assert tn._get() is _build.host_library("pcl_native")
    assert (_build.CSRC / "pcl_native.cpp").exists()
    for f in list(PORT.rglob("*.py")) + list(PORT.rglob("*.cpp")):
        text = f.read_text()
        assert "pcl_tpu/native" not in text and "pcl_tpu.native" not in text, f


def test_without_a_compiler_the_fallbacks_run_and_say_so(monkeypatch, cloud, queries):
    def no_compiler(name):
        raise RuntimeError("no host compiler")

    monkeypatch.setattr(_build, "host_library", no_compiler)
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_tried", False)
    assert not tn.available()
    d2, ii = tn.KdTree(cloud).knn(queries, 4)
    want = tn._knn_numpy(cloud, queries, 4)
    np.testing.assert_array_equal(d2, want[0])
    np.testing.assert_array_equal(ii, want[1])
    np.testing.assert_array_equal(tn.morton_encode(cloud), tn._morton_encode_numpy(cloud))
    np.testing.assert_array_equal(tn.morton_argsort(cloud),
                                  np.argsort(tn._morton_encode_numpy(cloud), kind="stable"))
    np.testing.assert_array_equal(tn.voxel_centroids(cloud, 0.3),
                                  tn._voxel_centroids_numpy(cloud, 0.3))


def _ties():
    """A grid with every point twice and queries on grid points and halfway
    between: many equally distant neighbours."""
    g = np.stack(np.meshgrid(*[np.arange(6, dtype=np.float32)] * 3), -1).reshape(-1, 3)
    pts = np.concatenate([g, g]) * np.float32(0.1)
    q = np.concatenate([g[::7], g[::5] + np.float32(0.5)]) * np.float32(0.1)
    return pts, q


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("k", [1, 8, 40])
def test_knn_is_the_jax_packages(cloud, queries, case, k):
    pts, q = (cloud, queries) if case == "random" else _ties()
    got = tn.KdTree(pts).knn(q, k)
    want = jn.KdTree(pts).knn(q, k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_knn_against_the_fallback(cloud, queries):
    tree = tn.KdTree(cloud)
    for k in (1, 8, 2001):
        d2, ii = tree.knn(queries, k)
        d2_ref, _ = tn._knn_numpy(cloud, queries, k)
        np.testing.assert_allclose(d2, d2_ref, rtol=1e-6, atol=1e-6)
        live = ii >= 0
        got = ((queries[:, None, :] - cloud[np.maximum(ii, 0)]) ** 2).sum(-1)
        np.testing.assert_allclose(got[live], d2_ref[live], rtol=1e-6, atol=1e-6)
        assert (live.sum(1) == min(k, len(cloud))).all()
        assert np.isinf(d2[~live]).all()


def test_kd_tie_order_is_the_traversals():
    """C101: among equally distant points the tree returns the one its
    traversal meets first, the JAX package's choice, which is not always the
    lowest index (the fallback's argpartition gives yet another)."""
    pts, q = _ties()
    d2, ii = tn.KdTree(pts).knn(q, 1)
    np.testing.assert_array_equal(ii, jn.KdTree(pts).knn(q, 1)[1])
    d2_ref, _ = tn._knn_numpy(pts, q, 1)
    np.testing.assert_allclose(d2, d2_ref, rtol=1e-6, atol=1e-7)
    all_d2 = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
    lowest = np.argmin(all_d2, axis=1)
    assert (ii[:, 0] != lowest).any()


@pytest.mark.parametrize("cap", [16, 128])
def test_radius_is_the_jax_packages_and_the_fallbacks(cloud, queries, cap):
    r = 0.25
    got = tn.KdTree(cloud).radius(queries, r, cap=cap)
    want = jn.KdTree(cloud).radius(queries, r, cap=cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    d2, ii, cnt = got
    d2_ref, _, cnt_ref = tn._radius_numpy(cloud, queries, r, cap)
    np.testing.assert_array_equal(cnt, cnt_ref)
    np.testing.assert_allclose(d2, d2_ref, rtol=1e-6, atol=1e-6)
    live = ii >= 0
    assert (live.sum(1) == np.minimum(cnt, cap)).all()
    again = ((queries[:, None, :] - cloud[np.maximum(ii, 0)]) ** 2).sum(-1)
    np.testing.assert_allclose(again[live], d2[live], rtol=1e-6, atol=1e-7)


def test_radius_reports_the_count_past_its_cap(cloud):
    d2, ii, cnt = tn.KdTree(cloud).radius(np.zeros((1, 3), np.float32), 10.0, cap=16)
    assert int(cnt[0]) == len(cloud) and (ii[0] >= 0).all()


def test_empty_and_short_trees():
    q = np.zeros((2, 3), np.float32)
    d2, ii = tn.KdTree(np.zeros((0, 3), np.float32)).knn(q, 3)
    assert (ii == -1).all() and np.isinf(d2).all()
    pts = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    d2, ii = tn.KdTree(pts).knn(q[:1], 5)
    assert (ii[0, :3] >= 0).all() and (ii[0, 3:] == -1).all()
    np.testing.assert_allclose(d2[0, :3], [0.0, 1.0, 4.0], atol=1e-6)


def test_tensors_on_any_device_are_taken_to_the_host(cloud, queries):
    got = tn.KdTree(torch.from_numpy(cloud)).knn(torch.from_numpy(queries), 4)
    want = tn.KdTree(cloud).knn(queries, 4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(tn.morton_encode(torch.from_numpy(cloud)),
                                  tn.morton_encode(cloud))
    assert isinstance(tn.voxel_centroids(torch.from_numpy(cloud), 0.3), np.ndarray)


def _deinterleave(codes):
    """Each axis' 21-bit quantized coordinate of a Morton code."""
    out = np.zeros((len(codes), 3), np.int64)
    for b in range(21):
        for a in range(3):
            out[:, a] |= ((codes >> np.uint64(3 * b + a)) & np.uint64(1)).astype(np.int64) << b
    return out


@pytest.mark.parametrize("scene", ["uniform", "street", "lattice"])
def test_morton_keys(scene):
    rng = np.random.default_rng(6)
    pts = {"uniform": rng.uniform(-50, 50, (20000, 3)),
           "street": np.column_stack([rng.uniform(-10, 10, 20000), np.full(20000, -1.7),
                                      rng.uniform(0, 60, 20000)]),
           "lattice": np.round(rng.uniform(0, 4, (5000, 3)))}[scene].astype(np.float32)
    codes = tn.morton_encode(pts)
    np.testing.assert_array_equal(codes, jn.morton_encode(pts))
    # a float32 product by (2^21 - 1) / w against the fallback's quotient:
    # within one step on each axis
    step = np.abs(_deinterleave(codes) - _deinterleave(tn._morton_encode_numpy(pts)))
    assert step.max() <= 1
    order = tn.morton_argsort(pts)
    np.testing.assert_array_equal(order, jn.morton_argsort(pts))
    assert sorted(order.tolist()) == list(range(len(pts)))
    assert (np.diff(codes[order].astype(np.float64)) >= 0).all()
    # C99: std::sort is not stable; equal codes may come in any order, so
    # orders are compared where a code is its own
    stable = np.argsort(codes, kind="stable")
    uniq, counts = np.unique(codes, return_counts=True)
    single = np.isin(codes[stable], uniq[counts == 1])
    np.testing.assert_array_equal(order[single], stable[single])
    if scene == "lattice":
        assert (counts > 1).any() and (order != stable).any()


def test_morton_locality():
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 1, size=(512, 3)).astype(np.float32)
    d = np.linalg.norm(np.diff(pts[tn.morton_argsort(pts)], axis=0), axis=1)
    assert d.mean() < 0.35


@pytest.mark.parametrize("leaf", [0.07, 0.3])
def test_voxel_centroids(cloud, leaf):
    got = tn.voxel_centroids(cloud, leaf)
    np.testing.assert_array_equal(got, jn.voxel_centroids(cloud, leaf))
    ref = tn._voxel_centroids_numpy(cloud, leaf)
    # both list the voxels in the order of their keys (x major)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_voxel_centroids_bin_from_the_minimum():
    """C100: two points 0.1 m apart straddling x = 0.2 share one 0.2 m voxel
    counted from their minimum; voxel_downsample's absolute grid splits them."""
    pts = np.array([[0.15, 0, 0], [0.25, 0, 0]], np.float32)
    assert len(tn.voxel_centroids(pts, 0.2)) == 1
    c = voxel_downsample(from_numpy(pts, device="cpu"), 0.2)
    assert int(c.mask.sum()) == 2
