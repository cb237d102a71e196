"""Parity of the rest of pcl_tpu_torch.filters with pcl_tpu.filters on the
CPU, the same numpy inputs through both.

Tolerances:
- masks and index sets exactly, except where a decision compares a float32
  sum taken in another order with a threshold: the statistical outlier
  filter (points whose mean k-NN distance lies within 1e-5 of the
  threshold, counted and left out; none here);
- positions from weighted sums over neighbours (``convolution_3d``, the
  pyramid, ``normal_refinement``, ``bilateral_filter``) to 1e-5 of their
  scale; products of a few terms (projections, separable convolutions) to
  1e-6;
- samplers through their cores on the JAX package's own draws (ROADMAP C17):
  the same picks exactly.
"""
import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import filters as jf
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.sac import models as jmodels

from pcl_tpu_torch import filters as tf
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.filters import sampling as tsampling
from pcl_tpu_torch.sac import models as tmodels


def _clouds(xyz, mask=None, width=0, height=1, **attrs):
    xyz = np.asarray(xyz, np.float32)
    mask = np.ones(len(xyz), bool) if mask is None else np.asarray(mask)
    xyz = np.where(mask[:, None], xyz, 0.0).astype(np.float32)
    jc = JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask),
                attrs={k: jnp.asarray(v) for k, v in attrs.items()}, width=width, height=height)
    tc = Cloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask),
               attrs={k: torch.from_numpy(np.asarray(v)) for k, v in attrs.items()},
               width=width, height=height)
    return jc, tc


def _random(rng, n=600, extent=2.0, valid=0.9, **kw):
    xyz = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return _clouds(xyz, rng.random(n) < valid, normal=nrm,
                   intensity=rng.random(n).astype(np.float32), **kw)


def _same_mask(t, j):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))


def _same_xyz(t, j, atol):
    _same_mask(t, j)
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["x", "z_neg", "attr", "box", "box_T", "fn", "plane"])
def test_passthrough_filters_match_jax(rng, case):
    jc, tc = _random(rng)
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [0.2, -0.1, 0.3]
    run = {
        "x": lambda f, c: f.pass_through(c, "x", -0.5, 1.0),
        "z_neg": lambda f, c: f.pass_through(c, "z", -0.5, 1.0, negative=True),
        "attr": lambda f, c: f.pass_through(c, "intensity", 0.2, 0.7),
        "box": lambda f, c: f.crop_box(c, [-1.0, -0.5, -1.5], [1.0, 1.5, 0.5]),
        "box_T": lambda f, c: f.crop_box(
            c, [-1.0, -0.5, -1.5], [1.0, 1.5, 0.5],
            transform=(jnp.asarray(T) if f is jf else torch.from_numpy(T)), negative=True),
        "fn": lambda f, c: f.function_filter(c, lambda q: q.xyz[:, 0] > q.xyz[:, 1]),
        "plane": lambda f, c: f.clip_plane(c, [0.3, -0.5, 0.8, 0.1]),
    }[case]
    _same_xyz(run(tf, tc), run(jf, jc), 0.0)


def test_samplers_match_jax_on_its_draws(rng):
    jc, tc = _random(rng, n=500)
    key = jax.random.PRNGKey(3)
    # random_sample draws z = uniform(key, (n,))
    z = np.array(jax.random.uniform(key, (jc.capacity,)))
    got = tsampling.random_sample_core(tc, 64, torch.from_numpy(z))
    _same_xyz(got, jf.random_sample(jc, 64, key), 0.0)
    # farthest_point_sample draws its start with choice(key, n, p=mask/count)
    start = int(jax.random.choice(key, jc.capacity, p=jc.mask / jnp.maximum(jc.count, 1)))
    got = tsampling.farthest_point_sample_core(tc, 48, start)
    _same_xyz(got, jf.farthest_point_sample(jc, 48, key), 0.0)
    # normal_space_sample draws z = uniform(key, (n,)) as well
    got = tsampling.normal_space_sample_core(tc, 80, torch.from_numpy(z))
    _same_xyz(got, jf.normal_space_sample(jc, 80, key), 0.0)


def test_samplers_draw_on_the_clouds_device(rng):
    _, tc = _random(rng, n=300)
    for fn in (tf.random_sample, tf.farthest_point_sample, tf.normal_space_sample):
        a, b = fn(tc, 32), fn(tc, 32, torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(a.xyz.numpy(), b.xyz.numpy())
        assert int(a.mask.sum()) == 32


def _blobs(rng, n=1200):
    """Clusters and a few isolated points."""
    centers = rng.uniform(-3, 3, size=(12, 3))
    pts = centers[rng.integers(0, 12, n - 30)] + rng.normal(scale=0.15, size=(n - 30, 3))
    lone = rng.uniform(-6, 6, size=(30, 3))
    return np.concatenate([pts, lone]).astype(np.float32)


@pytest.mark.parametrize("backend", ["bruteforce", "cell"])
def test_statistical_outlier_removal_matches_jax(rng, backend):
    xyz = _blobs(rng)
    jc, tc = _clouds(xyz, rng.random(len(xyz)) < 0.95)
    kw = dict(mean_k=12, stddev_mult=1.0, backend=backend)
    got, want = tf.statistical_outlier_removal(tc, **kw), jf.statistical_outlier_removal(jc, **kw)
    _same_mask(got, want)
    assert 0 < int(got.mask.sum()) < int(tc.mask.sum())
    neg = tf.statistical_outlier_removal(tc, negative=True, **kw)
    _same_mask(neg, jf.statistical_outlier_removal(jc, negative=True, **kw))


@pytest.mark.parametrize("backend,cap", [("bruteforce", None), ("cell", 64), ("cell", 4)])
def test_radius_outlier_removal_matches_jax(rng, backend, cap):
    """Cap 4 overflows the buckets: the ambiguous points are counted
    exactly by brute force in both packages."""
    xyz = _blobs(rng)
    jc, tc = _clouds(xyz)
    kw = dict(radius=0.3, min_neighbors=3, backend=backend, cell_cap=cap)
    _same_mask(tf.radius_outlier_removal(tc, **kw), jf.radius_outlier_removal(jc, **kw))
    if backend == "cell":
        tk, ta = tf.radius_outlier_keep(tc, 0.3, 3, cell_cap=cap)
        jk, ja = jf.radius_outlier_keep(jc, 0.3, 3, cell_cap=cap)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert (cap == 4) == bool(ta.any())


def _cube_hull():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    # two triangles a face, indices into v (bit 2: x, bit 1: y, bit 0: z)
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tri = np.array([t for a, b, c, d in faces for t in ((a, b, c), (a, c, d))], np.int32)
    return v * np.float32(0.9) + np.float32([0.05, -0.07, 0.03]), tri


@pytest.mark.parametrize("negative", [False, True])
def test_crop_hull_matches_jax(rng, negative):
    jc, tc = _random(rng, n=800)
    v, tri = _cube_hull()
    got = tf.crop_hull(tc, v, tri, negative=negative)
    _same_mask(got, jf.crop_hull(jc, v, tri, negative=negative))
    inside = np.all(np.abs(tc.xyz.numpy() - [0.05, -0.07, 0.03]) <= 0.9, axis=1)
    np.testing.assert_array_equal(got.mask.numpy(), (inside ^ negative) & tc.mask.numpy())


def test_conditional_removal_matches_jax(rng):
    jc, tc = _random(rng)

    def cond(f):
        return f.or_(f.and_(f.gt(f.field("x"), -0.5), f.le(f.field("intensity"), 0.6)),
                     f.not_(f.ge(f.field("z"), -1.2)), f.lt(f.field("y"), -1.5))

    _same_mask(tf.conditional_removal(tc, cond(tf)), jf.conditional_removal(jc, cond(jf)))


@pytest.mark.parametrize("window,max_movement", [(3, np.inf), (5, 0.05)])
def test_median_filter_matches_jax(rng, window, max_movement):
    H, W = 12, 16
    v, u = np.mgrid[0:H, 0:W]
    xyz = np.stack([u * 0.1, v * 0.1, 1.0 + 0.2 * np.sin(u * 0.5) + rng.normal(
        scale=0.05, size=(H, W))], -1).reshape(-1, 3).astype(np.float32)
    jc, tc = _clouds(xyz, rng.random(H * W) < 0.8, width=W, height=H)
    got = tf.median_filter(tc, window, max_movement)
    _same_xyz(got, jf.median_filter(jc, window, max_movement), 1e-6)
    with pytest.raises(ValueError, match="organized"):
        tf.median_filter(_clouds(xyz)[1])


def _terrain(rng, n=3000):
    """Ground rising gently, with boxes (buildings) and trees above it."""
    xy = rng.uniform(0, 40, size=(n, 2))
    z = 0.05 * xy[:, 0] + rng.normal(scale=0.03, size=n)
    on_box = (np.abs(xy[:, 0] - 12) < 3) & (np.abs(xy[:, 1] - 20) < 4)
    z = np.where(on_box, z + 6.0, z)
    tree = rng.random(n) < 0.05
    z = np.where(tree, z + rng.uniform(1, 4, n), z)
    return np.column_stack([xy, z]).astype(np.float32), on_box | tree


@pytest.mark.parametrize("operator", ["erode", "dilate", "open", "close"])
def test_morphological_filter_matches_jax(rng, operator):
    """At the default window: the JAX function traces ``window_size`` when it
    is passed, and ``reduce_window`` refuses a traced window (ROADMAP C38)."""
    xyz, _ = _terrain(rng)
    jc, tc = _clouds(xyz, rng.random(len(xyz)) < 0.95)
    got = tf.morphological_filter(tc, 1.0, operator=operator, grid=64)
    want = jf.morphological_filter(jc, 1.0, operator=operator, grid=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if operator == "erode":
        with pytest.raises(jax.errors.TracerArrayConversionError):
            jf.morphological_filter(jc, 1.0, window_size=5, operator=operator, grid=64)


def test_progressive_morphological_filter_matches_jax(rng):
    xyz, raised = _terrain(rng)
    jc, tc = _clouds(xyz)
    kw = dict(cell_size=1.0, max_window_size=20, slope=1.0, initial_distance=0.5,
              max_distance=3.0, grid=64)
    got = tf.progressive_morphological_filter(tc, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jf.progressive_morphological_filter(jc, **kw)))
    g = got.numpy()
    assert g[~raised].mean() > 0.95 and g[raised].mean() < 0.2


def test_convolution_3d_matches_jax(rng):
    jc, tc = _random(rng, n=500, extent=1.0)
    for kw in (dict(radius=0.3), dict(radius=0.4, sigma=0.1, k=16)):
        _same_xyz(tf.convolution_3d(tc, **kw), jf.convolution_3d(jc, **kw), 1e-5)


@pytest.mark.parametrize("border", ["duplicate", "mirror", "ignore"])
def test_separable_convolutions_match_jax(rng, border):
    img = rng.normal(size=(9, 11, 3)).astype(np.float32)
    kern = np.float32([0.1, 0.2, 0.4, 0.2, 0.1])
    for tfn, jfn in ((tf.convolution_rows, jf.convolution_rows),
                     (tf.convolution_cols, jf.convolution_cols)):
        got = tfn(torch.from_numpy(img), torch.from_numpy(kern), border)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(img),
                                                               jnp.asarray(kern), border)),
                                   rtol=0, atol=1e-6)


def test_pyramid_matches_jax(rng):
    H, W = 24, 32
    v, u = np.mgrid[0:H, 0:W]
    img = np.stack([u * 0.01, v * 0.01, 1.0 + 0.1 * np.cos(u * 0.3)], -1).astype(np.float32)
    valid = rng.random((H, W)) < 0.9
    got = tf.pyramid(torch.from_numpy(img), torch.from_numpy(valid), levels=3)
    want = jf.pyramid(img, valid, levels=3)
    assert len(got) == len(want) == 3
    for (gx, gv), (wx, wv) in zip(got, want):
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_allclose(gx.numpy(), wx, rtol=0, atol=1e-5)


def test_host_samplers_match_jax(rng):
    jc, tc = _random(rng, n=700)
    np.testing.assert_array_equal(tf.covariance_sampling(tc, 50),
                                  jf.covariance_sampling(jc, 50))
    got = tf.sampling_surface_normal(tc, 1.0, samples_per_cell=3, seed=4)
    want = jf.sampling_surface_normal(jc, 1.0, samples_per_cell=3, seed=4)
    _same_xyz(got, want, 0.0)
    np.testing.assert_array_equal(got.attrs["normal"].numpy(), np.asarray(want.attrs["normal"]))
    assert got.xyz.device == tc.xyz.device


def test_frustum_and_models_match_jax(rng):
    jc, tc = _random(rng, n=800, extent=3.0)
    pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    pose[:2, :2] = [[c, -s], [s, c]]
    pose[:3, 3] = [-2.0, 0.5, 0.1]
    kw = dict(h_fov=1.2, v_fov=0.8, near=0.5, far=4.0)
    _same_mask(tf.frustum_culling(tc, torch.from_numpy(pose), **kw),
               jf.frustum_culling(jc, jnp.asarray(pose), **kw))
    coef = np.float32([0.3, -0.2, 0.93, 0.4])
    coef[:3] /= np.linalg.norm(coef[:3])
    tm, jm = tmodels.PlaneModel(), jmodels.PlaneModel()
    _same_xyz(tf.project_inliers(tc, tm, torch.from_numpy(coef)),
              jf.project_inliers(jc, jm, jnp.asarray(coef)), 1e-6)
    _same_mask(tf.model_outlier_removal(tc, tm, torch.from_numpy(coef), 0.5),
               jf.model_outlier_removal(jc, jm, jnp.asarray(coef), 0.5))


def test_grid_filters_match_jax(rng):
    xyz, _ = _terrain(rng, n=2000)
    xyz[::7, :2] = -xyz[::7, :2]                 # negative cells too
    jc, tc = _clouds(xyz, rng.random(len(xyz)) < 0.9)
    for res in (1.0, 2.5):
        _same_mask(tf.grid_minimum(tc, res), jf.grid_minimum(jc, res))
    _same_mask(tf.local_maximum(tc, 1.5, cap=16), jf.local_maximum(jc, 1.5, cap=16))
    for leaf in (0.7, 3.0):
        got, want = tf.approximate_voxel_grid(tc, leaf), jf.approximate_voxel_grid(jc, leaf)
        _same_xyz(got, want, 1e-5)
    idx = np.array([0, 5, 17, 400, 1999])
    for neg in (False, True):
        _same_mask(tf.extract_indices(tc, torch.from_numpy(idx), neg),
                   jf.extract_indices(jc, jnp.asarray(idx), neg))


def test_attribute_filters_match_jax(rng):
    jc, tc = _random(rng, n=600, extent=0.6)
    _same_mask(tf.shadow_points(tc, 0.3), jf.shadow_points(jc, 0.3))
    got, want = tf.bilateral_filter(tc, 0.05, 0.2, cap=16), jf.bilateral_filter(jc, 0.05, 0.2,
                                                                                cap=16)
    np.testing.assert_allclose(got.attrs["intensity"].numpy(),
                               np.asarray(want.attrs["intensity"]), rtol=0, atol=1e-5)
    # at the default iterations: passed, the JAX function traces them (C38)
    got, want = tf.normal_refinement(tc, k=6), jf.normal_refinement(jc, k=6)
    np.testing.assert_allclose(got.attrs["normal"].numpy(), np.asarray(want.attrs["normal"]),
                               rtol=0, atol=1e-5)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jf.normal_refinement(jc, k=6, iterations=2)
