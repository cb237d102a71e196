"""Parity of the port's ``image.ops`` and ``ml.trees`` with the JAX package
on the CPU.

Tolerances:
- Correlations (``convolve2d``, the blur) to 1e-5 of the image's largest
  value: the two libraries sum a window in different orders. Sobel and
  Prewitt on integer images, erosion, dilation and the masks: equal.
- Canny on gradients the test gives: equal, also when the hysteresis stops
  at its cap of 64 sweeps. Canny from an image: equal on a step image whose
  gradients are far from every decision.
- Trees, ferns and forests: the same seeds give the same arrays bit for bit,
  and each package's model files load in the other.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.image import ops as jops
from pcl_tpu.ml import trees as jtrees

from pcl_tpu_torch import interop
from pcl_tpu_torch.image import ops as tops
from pcl_tpu_torch.ml import trees as ttrees


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _a(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("shape,ksize", [((17, 23), (3, 3)), ((16, 20), (4, 4)),
                                         ((12, 9), (2, 5)), ((10, 14), (5, 2))],
                         ids=["odd", "even", "2x5", "5x2"])
def test_convolve2d_matches_jax(shape, ksize):
    rng = np.random.default_rng(sum(shape) + ksize[0])
    img = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=ksize).astype(np.float32)
    a = _a(tops.convolve2d(_t(img), _t(k)))
    b = np.asarray(jops.convolve2d(jnp.asarray(img), jnp.asarray(k)))
    assert a.shape == b.shape == shape
    np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("size,sigma", [(5, 1.0), (4, 0.8), (7, 2.0)])
def test_gaussian_kernel_and_blur_match_jax(size, sigma):
    img = np.random.default_rng(size).uniform(0, 255, (19, 22)).astype(np.float32)
    np.testing.assert_allclose(_a(tops.gaussian_kernel(size, sigma)),
                               np.asarray(jops.gaussian_kernel(size, sigma)), rtol=1e-6)
    b = np.asarray(jops.gaussian_blur(jnp.asarray(img), size, sigma))
    np.testing.assert_allclose(_a(tops.gaussian_blur(_t(img), size, sigma)), b, atol=1e-5 * 255)


@pytest.mark.parametrize("op", ["sobel", "prewitt"])
def test_gradients_on_integer_images_are_exact(op):
    img = np.random.default_rng(3).integers(0, 256, (21, 18)).astype(np.float32)
    for a, b in zip(getattr(tops, op)(_t(img)), getattr(jops, op)(jnp.asarray(img))):
        np.testing.assert_array_equal(_a(a), np.asarray(b))


@pytest.mark.parametrize("size", [2, 3, 4, 5])
@pytest.mark.parametrize("op", ["erode", "dilate"])
def test_morphology_matches_jax(op, size):
    img = np.random.default_rng(size).normal(size=(13, 16)).astype(np.float32)
    a = _a(getattr(tops, op)(_t(img), size))
    b = np.asarray(getattr(jops, op)(jnp.asarray(img), size))
    np.testing.assert_array_equal(a, b)


def _line_gradients(length=100, strong_at=(0,)):
    """A horizontal line of weak gradient (pointing up) across a 9 x 128
    image, strong at ``strong_at``: non-maximum suppression keeps the whole
    line, and hysteresis grows one pixel a sweep from each strong one."""
    gx = np.zeros((9, 128), np.float32)
    gy = np.zeros((9, 128), np.float32)
    gy[4, :length] = 3.0
    for c in strong_at:
        gy[4, c] = 10.0
    return gx, gy


@pytest.mark.parametrize("strong_at,expect", [((0,), 65), ((0, 99), 100), ((50,), 100)],
                         ids=["capped", "converged", "middle"])
def test_canny_hysteresis_sweeps_and_cap(strong_at, expect):
    """From one end of a 100-pixel line the 64-sweep cap leaves 65 edge
    pixels, as the JAX package does; from both ends, or from the middle,
    the line is whole before the cap."""
    gx, gy = _line_gradients(strong_at=strong_at)
    a = _a(tops.canny_from_gradients(_t(gx), _t(gy), 2.0, 8.0))
    b = np.asarray(jops.canny_from_gradients(jnp.asarray(gx), jnp.asarray(gy), 2.0, 8.0))
    np.testing.assert_array_equal(a, b)
    assert int(a.sum()) == expect


def test_canny_from_gradients_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (24, 31)).astype(np.float32)
    gx, gy, _ = jops.sobel(jnp.asarray(img))
    gx, gy = np.asarray(gx), np.asarray(gy)
    for low, high in ((50.0, 200.0), (100.0, 400.0)):
        a = _a(tops.canny_from_gradients(_t(gx), _t(gy), low, high))
        b = np.asarray(jops.canny_from_gradients(jnp.asarray(gx), jnp.asarray(gy), low, high))
        np.testing.assert_array_equal(a, b)
        assert a.any() and not a.all()


def test_canny_on_a_step_image_matches_jax():
    """Each step climbs over one middle pixel, so the blurred gradient has
    one maximum across it: a symmetric step would tie two pixels, which the
    two libraries' blurs round apart."""
    img = np.zeros((32, 40), np.float32)
    img[:, 17] = 100.0
    img[:, 18:] = 200.0
    img[19, :] += 40.0
    img[20:, :] += 80.0
    a = _a(tops.canny(_t(img), 20.0, 60.0))
    b = np.asarray(jops.canny(jnp.asarray(img), 20.0, 60.0))
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 40


def _classes(rng, n=300):
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64) + 2 * (x[:, 1] + 0.3 * x[:, 2] > 0).astype(np.int64)
    return x, y


def _same_tree(a, b):
    np.testing.assert_array_equal(a.feature, b.feature)
    np.testing.assert_array_equal(a.threshold, b.threshold)
    np.testing.assert_array_equal(a.leaf_probs, b.leaf_probs)
    assert a.depth == b.depth


@pytest.fixture(scope="module")
def models():
    x, y = _classes(np.random.default_rng(11))
    out = {}
    for pkg, name in ((ttrees, "port"), (jtrees, "jax")):
        out[name] = dict(
            fern=pkg.train_fern(x, y, depth=5, seed=3),
            tree=pkg.train_decision_tree(x, y, depth=4, seed=2),
            forest=pkg.train_random_forest(x, y, n_trees=4, depth=4, seed=5))
    return x, y, out


def test_trees_grow_the_same_from_the_same_seeds(models):
    x, _, out = models
    p, j = out["port"], out["jax"]
    np.testing.assert_array_equal(p["fern"].features, j["fern"].features)
    np.testing.assert_array_equal(p["fern"].thresholds, j["fern"].thresholds)
    np.testing.assert_array_equal(p["fern"].leaf_probs, j["fern"].leaf_probs)
    _same_tree(p["tree"], j["tree"])
    for a, b in zip(p["forest"].trees, j["forest"].trees):
        _same_tree(a, b)
    for kind in ("fern", "tree", "forest"):
        np.testing.assert_array_equal(p[kind].evaluate(x), j[kind].evaluate(x))
        np.testing.assert_array_equal(p[kind].classify(x), j[kind].classify(x))


@pytest.mark.parametrize("kind", ["fern", "tree", "forest"])
def test_model_files_load_in_both_packages(models, tmp_path, kind):
    x, _, out = models
    for saver, loader, name in ((ttrees, jtrees, "port"), (jtrees, ttrees, "jax")):
        path = str(tmp_path / f"{kind}_{name}.npz")
        saver.save_model(path, out[name][kind])
        back = loader.load_model(path)
        np.testing.assert_array_equal(back.evaluate(x), out["jax"][kind].evaluate(x))


def test_forest_from_arrays_evaluates_as_the_jax_forest(models):
    x, _, out = models
    jf = out["jax"]["forest"]
    f = interop.forest_from_arrays([(t.feature, t.threshold, t.leaf_probs, t.depth)
                                    for t in jf.trees])
    np.testing.assert_array_equal(f.evaluate(x), jf.evaluate(x))
