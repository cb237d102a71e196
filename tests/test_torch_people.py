"""Parity of the port's ``people`` (HOG, the person classifier, the
ground-based detector) with the JAX package on the CPU.

Tolerances:
- ``hog_features``: blocks to 1e-5, compared where every pixel of the
  block's cells has its float64 orientation more than 1e-5 rad from a bin
  edge (torch's and XLA's ``atan2`` differ in the last bit, ROADMAP C78)
  or exactly on edge 0 (no vertical gradient); at least 90% of the blocks
  are.
- ``dollar_hog``, ``_resize_rgb`` and ``PersonClassifier``: host numpy on
  both sides, equal bit for bit.
- The detector on a synthetic room (floor, two people, a low box): the same
  candidates, centroids, heights and counts bit for bit (host numpy on the
  same clouds and clusters), the HOG confidence equal, the SVM stage's
  score to 1e-5 relative. The RANSAC ground runs the port's core on the JAX
  package's draws (C17); its refined plane rounds apart (the SAC tests'
  1e-4), so heights above it agree to 1e-6 m (my CPU run: 2.4e-8 m).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sac import _jax_draws

from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.ml import svm as jsvm
from pcl_tpu.people import classifier as jcls
from pcl_tpu.people import detector as jdet
from pcl_tpu.people import hog as jhog

from pcl_tpu_torch import interop
from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.people import classifier as tcls
from pcl_tpu_torch.people import detector as tdet
from pcl_tpu_torch.people import hog as thog

K = np.array([[131.25, 0, 79.5], [0, 131.25, 59.5], [0, 0, 1.0]])


def _edge_gap(ang, n_bins=9):
    """float64 distance of each orientation in [0, pi) to its nearest bin
    edge."""
    x = np.mod(ang, np.pi) / np.pi * n_bins
    return np.abs(x - np.round(x)) * np.pi / n_bins


@pytest.mark.parametrize("shape,cell", [((64, 48), 8), ((50, 45), 8), ((36, 36), 6)])
def test_hog_features_match_jax_off_bin_edges(shape, cell):
    rng = np.random.default_rng(shape[0])
    img = rng.uniform(0, 255, shape).astype(np.float32)
    img[10:20, 5:30] = 200.0                       # flat patches: zero gradients
    want = np.asarray(jhog.hog_features(jnp.asarray(img), cell_size=cell))
    got = thog.hog_features(torch.from_numpy(img), cell_size=cell).numpy()
    assert got.shape == want.shape
    g = img.astype(np.float64)
    gx = np.roll(g, -1, 1) - np.roll(g, 1, 1)
    gy = np.roll(g, -1, 0) - np.roll(g, 1, 0)
    # atan2(0, x) is 0 or pi exactly in both libraries: bin 0
    firm_px = (_edge_gap(np.arctan2(gy, gx)) > 1e-5) | (gy == 0)
    H, W = shape
    ch, cw = H // cell, W // cell
    firm_cell = np.ones((ch, cw), bool)
    for y in range(H):
        for x in range(W):
            c = (y // cell) * cw + x // cell     # the JAX package's cell id (rows alias)
            if c < ch * cw and not firm_px[y, x]:
                firm_cell.reshape(-1)[c] = False
    bh, bw = ch - 1, cw - 1
    firm_blk = (firm_cell[:bh, :bw] & firm_cell[1:, :bw] & firm_cell[:bh, 1:]
                & firm_cell[1:, 1:]).reshape(-1)
    assert firm_blk.mean() >= 0.9
    np.testing.assert_allclose(got[firm_blk], want[firm_blk], atol=1e-5)


def test_dollar_hog_and_classifier_are_the_jax_ones():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (128, 64, 3))
    np.testing.assert_array_equal(tcls.dollar_hog(img), jcls.dollar_hog(img))
    box = rng.uniform(0, 1, (97, 41, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcls._resize_rgb(box, 64, 128), jcls._resize_rgb(box, 64, 128))
    weights = rng.normal(size=3024).astype(np.float32) * 0.1
    model = {"window_height": 128, "window_width": 64, "b": 0.25, "weights": weights}
    tc = interop.person_classifier_from_arrays(128, 64, 0.25, weights)
    jc = jcls.PersonClassifier(model)
    frame = rng.uniform(0, 1, (120, 160, 3)).astype(np.float32)
    for xc, yc, ph in ((80.0, 60.0, 70.0), (5.0, 100.0, 90.0), (150.0, 10.0, 40.0),
                       (80.0, 60.0, 0.0)):
        a, b = tc.evaluate(frame, xc, yc, ph), jc.evaluate(frame, xc, yc, ph)
        assert a == b or (np.isnan(a) and np.isnan(b))


def _room(seed=0):
    """Camera-frame points (y down): a floor at y = 1.2, two upright people
    (1.75 and 1.62 m) and a 0.6 m box, with a little noise."""
    rng = np.random.default_rng(seed)
    floor = np.stack([rng.uniform(-2, 2, 3000), np.full(3000, 1.2), rng.uniform(1.5, 5, 3000)], 1)
    parts = [floor]
    for (x, z), h in (((-0.8, 3.0), 1.75), ((0.9, 3.6), 1.62)):
        th = rng.uniform(0, 2 * np.pi, 700)
        y = 1.2 - rng.uniform(0.02, h, 700)
        r = np.where(y < 1.2 - h + 0.22, 0.1, 0.18)
        parts.append(np.stack([x + r * np.cos(th), y, z + r * np.sin(th)], 1))
    box = np.stack([rng.uniform(-0.3, 0.1, 300), 1.2 - rng.uniform(0.02, 0.6, 300),
                    rng.uniform(4.0, 4.3, 300)], 1)
    parts.append(box)
    pts = np.concatenate(parts) + 0.004 * rng.normal(size=(sum(len(p) for p in parts), 3))
    return pts.astype(np.float32)


def _same(a, b, score_rtol=0.0, height_atol=0.0):
    assert len(a) == len(b) == 2
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.centroid, q.centroid)
        assert p.n_points == q.n_points
        np.testing.assert_allclose(p.height, q.height, rtol=0, atol=height_atol)
        np.testing.assert_allclose(p.score, q.score, rtol=score_rtol)


def test_detector_on_ransac_ground_matches_jax():
    pts = _room()
    mask = np.ones(len(pts), bool)
    key = jax.random.PRNGKey(0)
    want = jdet.GroundBasedPeopleDetector().detect(jmake(jnp.asarray(pts)), key=key)
    idx, sub = _jax_draws(key, 1024, 3, mask)
    det = tdet.GroundBasedPeopleDetector()
    got = det.detect(make_cloud(pts, device="cpu"), samples=(idx, sub))
    _same(got, want, height_atol=1e-6)
    np.testing.assert_allclose(sorted(p.height for p in got), [1.62, 1.75], atol=0.02)


def test_detector_keeps_the_ransac_plane_for_the_next_frames():
    """``last_ground`` is the turned plane that ``detect`` used (PCL's
    getGround), the one ``ground`` returns; set as the ground (setGround) it
    finds the same people in the same cloud."""
    pts = _room()
    mask = np.ones(len(pts), bool)
    idx, sub = _jax_draws(jax.random.PRNGKey(0), 1024, 3, mask)
    det = tdet.GroundBasedPeopleDetector()
    cloud = make_cloud(pts, device="cpu")
    assert det.last_ground is None
    first = det.detect(cloud, samples=(idx, sub))
    np.testing.assert_array_equal(det.last_ground, det.ground(cloud, samples=(idx, sub))[1])
    assert det.last_ground[1] < 0         # the floor below the camera: the normal points up
    det.ground_coeffs = det.last_ground
    again = det.detect(cloud)
    assert [p.n_points for p in again] == [p.n_points for p in first]
    np.testing.assert_allclose([p.height for p in again], [p.height for p in first], atol=1e-6)


def test_detector_with_set_ground_and_hog_confidence_matches_jax():
    pts = _room(1)
    rng = np.random.default_rng(2)
    weights = rng.normal(size=3024).astype(np.float32) * 0.05
    model = {"window_height": 128, "window_width": 64, "b": -2.0, "weights": weights}
    frame = rng.uniform(0, 1, (120, 160, 3)).astype(np.float32)
    kw = dict(ground_coeffs=np.array([0.0, -1.0, 0.0, 1.2]), intrinsics=K, min_confidence=-50.0)
    want = jdet.GroundBasedPeopleDetector(classifier=jcls.PersonClassifier(model), **kw).detect(
        jmake(jnp.asarray(pts)), rgb_image=frame)
    got = tdet.GroundBasedPeopleDetector(
        classifier=interop.person_classifier_from_arrays(128, 64, -2.0, weights), **kw).detect(
        make_cloud(pts, device="cpu"), rgb_image=frame)
    _same(got, want)
    assert all(np.isfinite(p.score) for p in got)


def test_detector_svm_stage_matches_jax():
    pts = _room(2)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(40, 7)).astype(np.float32) * [1, 0.5, 0.1, 0.3, 1.5, 0.3, 600] \
        + [0.2, 0.01, 0.001, 0.3, 1.2, 0.3, 600]
    labels = np.where(feats[:, 4] > 1.0, 1.0, -1.0).astype(np.float32)
    jm = jsvm.svm_train(jnp.asarray(feats.astype(np.float32)), jnp.asarray(labels),
                        kernel="linear", iterations=300)
    tm = interop.svm_model_from_arrays("linear", jm.w, jm.b, jm.support, jm.gamma, jm.mean,
                                       jm.scale, device="cpu")
    kw = dict(ground_coeffs=np.array([0.0, -1.0, 0.0, 1.2]))
    want = jdet.GroundBasedPeopleDetector(svm_model=jm, **kw).detect(jmake(jnp.asarray(pts)))
    got = tdet.GroundBasedPeopleDetector(svm_model=tm, **kw).detect(make_cloud(pts,
                                                                               device="cpu"))
    _same(got, want, score_rtol=1e-5)


def test_head_based_subclusters_split_two_people_standing_close():
    rng = np.random.default_rng(4)
    parts = []
    for x, h in ((-0.25, 1.8), (0.25, 1.65)):
        th = rng.uniform(0, 2 * np.pi, 500)
        parts.append(np.stack([x + 0.15 * np.cos(th), rng.uniform(0, h, 500),
                               0.15 * np.sin(th)], 1))
    pts = np.concatenate(parts)
    n = np.array([0.0, 1.0, 0.0])
    a = tdet.head_based_subclusters(pts, n, 0.0)
    b = jdet.head_based_subclusters(pts, n, 0.0)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
