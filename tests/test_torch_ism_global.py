"""Parity of the port's implicit shape model, depth-patch forest detector and
global recognition pipeline with the JAX package on the CPU.

Tolerances:
- ISM: both packages get the same descriptors (a numpy feature function)
  and the codebook's k-means runs its core on the JAX package's own draws
  (C17, C61): centres and weights to 1e-5, labels, classes and member lists
  equal; model files byte-equal; votes to 1e-5 wherever each keypoint's two
  nearest codebook centres differ by more than 1e-5 of the scale (every
  keypoint of these scenes); peaks equal.
- The detector: the same seeds give the same stencils, forest and
  detections, bit for bit.
- Global pipeline: VFH per view within 1e-4 plus two bins' weight per point
  that a rounding can move (as ``test_torch_global_desc.py``); ESF through
  its core on the JAX draws (C50); labels equal, refined poses to 1e-4, and
  a database the JAX package saved loads in the port.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
from test_global_recognition import _box, _sphere
from test_recognition_extended import TestFaceDetection
from test_torch_global_desc import _jax_esf_draw, _vfh_unsure

from pcl_tpu import features as jfeatures
from pcl_tpu.core.cloud import from_numpy as jfrom
from pcl_tpu.recognition import face_detection as jfd
from pcl_tpu.recognition import global_pipeline as jgp
from pcl_tpu.recognition import ism as jism

from pcl_tpu_torch import interop
from pcl_tpu_torch.core.cloud import from_numpy as tfrom
from pcl_tpu_torch.recognition import face_detection as tfd
from pcl_tpu_torch.recognition import global_pipeline as tgp
from pcl_tpu_torch.recognition import ism as tism



def _feature_fn(pts, nrm):
    """A numpy descriptor both packages share: per point, a histogram of
    its distances to the cloud's other points (8 bins over the diameter)
    and its normal's components."""
    p = np.asarray(pts, np.float64)
    d = np.linalg.norm(p[:, None] - p[None], axis=-1)
    top = max(float(d.max()), 1e-9)
    h = np.stack([((d >= top * b / 8) & (d < top * (b + 1) / 8)).sum(1) for b in range(8)], 1)
    return np.concatenate([h / len(p), np.abs(nrm) + 0.1], 1).astype(np.float32)


def _objects():
    """Two training objects (a tall box, a ball) with outward normals."""
    box = _box([0.2, 0.3, 0.5], n=600, seed=2)
    ball = _sphere(0.25, n=600, seed=3)
    nb = np.zeros_like(box)
    ax = np.abs(box / np.float32([0.2, 0.3, 0.5])).argmax(1)
    nb[np.arange(len(box)), ax] = np.sign(box[np.arange(len(box)), ax])
    return [box, ball], [nb, ball / np.linalg.norm(ball, axis=1, keepdims=True)]


def _jax_cluster_draws(n, k, attempts=5):
    """The JAX package's k-means initial indices for each attempt
    (``PRNGKey(a)``, ``kmeans.py``'s categorical, traced the same way)."""
    @jax.jit
    def draw(key):
        w = jnp.ones(n, jnp.float32)
        probs = w / jnp.maximum(jnp.sum(w), 1.0)
        return jax.random.categorical(key, jnp.log(probs + 1e-30)[None, :].repeat(k, 0))
    return [torch.from_numpy(np.array(draw(jax.random.PRNGKey(a)))).long()
            for a in range(attempts)]


@pytest.fixture(scope="module")
def ism_models():
    clouds, normals = _objects()
    kw = dict(sampling_size=0.08, n_clusters=12)
    jm = jism.train_ism(clouds, normals, [0, 1], _feature_fn, **kw)
    n_words = jm.n_visual_words
    tm = tism.train_ism(clouds, normals, [0, 1], _feature_fn, device="cpu",
                        init_indices=_jax_cluster_draws(n_words, 12), **kw)
    return clouds, normals, jm, tm


def test_ism_training_matches_jax_on_its_draws(ism_models, tmp_path):
    _, _, jm, tm = ism_models
    assert (tm.n_classes, tm.n_visual_words, tm.n_clusters, tm.dim) == \
        (jm.n_classes, jm.n_visual_words, jm.n_clusters, jm.dim)
    np.testing.assert_allclose(tm.clusters_centers, jm.clusters_centers, atol=1e-5)
    assert tm.clusters == jm.clusters
    np.testing.assert_array_equal(tm.classes, jm.classes)
    np.testing.assert_allclose(tm.sigmas, jm.sigmas, rtol=1e-6)
    np.testing.assert_allclose(tm.directions_to_center, jm.directions_to_center, atol=1e-6)
    np.testing.assert_allclose(tm.statistical_weights, jm.statistical_weights, rtol=1e-5)
    np.testing.assert_allclose(tm.learned_weights, jm.learned_weights, rtol=1e-5, atol=1e-7)
    # model files: byte-equal, each package reads the other's
    pj, pt = str(tmp_path / "j.ism"), str(tmp_path / "t.ism")
    jism.save_ism_model(jm, pj)
    tism.save_ism_model(interop.ism_model_from_arrays(
        jm.statistical_weights, jm.learned_weights, jm.classes, jm.sigmas,
        jm.directions_to_center, jm.clusters_centers, jm.clusters), pt)
    assert open(pj).read() == open(pt).read()
    back = tism.load_ism_model(pj)
    assert back.clusters == jm.clusters and back.dim == jm.dim
    assert jism.load_ism_model(pt).clusters == jm.clusters


def _nearest_firm(desc, centers, rel=1e-5):
    d = ((desc[:, None].astype(np.float64) - centers[None]) ** 2).sum(-1)
    part = np.sort(d, axis=1)
    scale = (desc.astype(np.float64) ** 2).sum(1) + (centers.astype(np.float64) ** 2).sum(1).max()
    return part[:, 1] - part[:, 0] > rel * scale


@pytest.mark.parametrize("cls", [0, 1])
def test_ism_votes_and_peaks_match_jax(ism_models, cls):
    clouds, normals, jm, _ = ism_models
    shift = np.float32([1.5, -0.4, 0.8])
    scene, snrm = clouds[cls] + shift, normals[cls]
    keep = jism.simplify_cloud(scene, 0.08)
    np.testing.assert_array_equal(tism.simplify_cloud(scene, 0.08), keep)
    assert _nearest_firm(_feature_fn(scene[keep], snrm[keep]), jm.clusters_centers).all()
    jv = jism.find_objects(jm, scene, snrm, cls, _feature_fn, sampling_size=0.08)
    tv = tism.find_objects(jm, scene, snrm, cls, _feature_fn, sampling_size=0.08, device="cpu")
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, atol=1e-5)
    sigma = float(jm.sigmas[cls])
    jp = jism.find_strongest_peaks(jv[0], jv[1], cls, sigma * 10.0, sigma)
    tp = tism.find_strongest_peaks(tv[0], tv[1], cls, sigma * 10.0, sigma)
    assert len(tp) == len(jp) > 0
    for (ca, da), (cb, db) in zip(tp, jp):
        np.testing.assert_allclose(ca, cb, atol=1e-5)
        assert abs(da - db) <= 1e-5 * abs(db)


def test_ism_feature_fn_may_return_a_tensor(ism_models):
    clouds, normals, jm, _ = ism_models
    a = tism.find_objects(jm, clouds[0], normals[0], 0, _feature_fn, 0.08, device="cpu")
    b = tism.find_objects(jm, clouds[0], normals[0], 0,
                          lambda p, n: torch.from_numpy(_feature_fn(p, n)), 0.08, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_ism_sampler_draws_attempts_from_their_seeds():
    a = tism.cluster_init_indices(50, 6, device="cpu")
    b = tism.cluster_init_indices(50, 6, device="cpu")
    assert len(a) == 5 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and all(int(x.max()) < 50 for x in a)


def test_face_detector_matches_jax():
    rng = np.random.default_rng(21)
    pos = [TestFaceDetection._head_patch(rng) for _ in range(30)]
    neg = [TestFaceDetection._clutter_patch(rng) for _ in range(30)]
    jd = jfd.train_face_detector(pos, neg, n_trees=5, depth=5, seed=4)
    td = tfd.train_face_detector(pos, neg, n_trees=5, depth=5, seed=4)
    np.testing.assert_array_equal(td.stencils, jd.stencils)
    for a, b in zip(td.forest.trees, jd.forest.trees):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_array_equal(a.leaf_probs, b.leaf_probs)
    H, W = 48, 64
    scene = (1.5 + 0.005 * np.arange(W)[None] + np.zeros((H, 1))).astype(np.float32)
    scene[12:36, 30:54] = TestFaceDetection._head_patch(rng)
    scene[5:9, 3:7] = 0.0
    jf = jfd.detect_faces(jd, scene, stride=3, threshold=0.5)
    tf = tfd.detect_faces(td, scene, stride=3, threshold=0.5)
    assert tf == jf and tf and abs(tf[0].y - 12) <= 6 and abs(tf[0].x - 30) <= 6


def _models():
    return {"tallbox": _box([0.06, 0.06, 0.25], n=1500),
            "ball": _sphere(0.08, n=1500)}


@pytest.fixture(scope="module")
def vfh_dbs():
    models = _models()
    jdb = jgp.train_global_database(models, descriptor="vfh", n_views=3)
    tdb = tgp.train_global_database(models, descriptor="vfh", n_views=3, device="cpu")
    return jdb, tdb


def test_vfh_database_matches_jax(vfh_dbs):
    jdb, tdb = vfh_dbs
    assert tdb.labels == jdb.labels
    for a, b in zip(tdb.views + tdb.poses, jdb.views + jdb.poses):
        np.testing.assert_array_equal(a, b)
    for v, a, b in zip(jdb.views, tdb.descs, jdb.descs):
        jc = jfeatures.estimate_normals(jfrom(v), k=16)
        n_unsure = _vfh_unsure(jc)
        assert np.abs(a - b).max() <= 1e-4 + 2 * 100.0 / len(v) * n_unsure


def _scene_clusters():
    views_t = jgp.render_views(_box([0.06, 0.06, 0.25], n=1500), n_views=3, seed=9)
    views_s = jgp.render_views(_sphere(0.08, n=1500), n_views=3, seed=9)
    return [views_t[1]["xyz"] + np.float32([0.5, 0.2, 0.1]),
            views_s[2]["xyz"] + np.float32([-0.3, 0.1, 0.0])]


def test_recognize_clusters_matches_jax_with_a_jax_saved_database(vfh_dbs, tmp_path):
    jdb, _ = vfh_dbs
    jdb.save(str(tmp_path / "db"))
    tdb = tgp.GlobalModelDatabase.load(str(tmp_path / "db"))
    assert tdb.labels == jdb.labels and tdb.descriptor == "vfh"
    np.testing.assert_array_equal(tdb.descs, jdb.descs)
    clusters = _scene_clusters()
    jr = jgp.recognize_clusters(jdb, clusters, n_candidates=2, refine_iterations=20)
    tr = tgp.recognize_clusters(tdb, clusters, n_candidates=2, refine_iterations=20,
                                device="cpu")
    assert [r.label for r in tr] == [r.label for r in jr] == ["tallbox", "ball"]
    for a, b in zip(tr, jr):
        assert a.view_index == b.view_index
        np.testing.assert_allclose(a.transform, b.transform, atol=1e-4)
        assert abs(a.distance - b.distance) <= 1e-5 * max(b.distance, 1.0) + 1e-3
    # the database carried across through interop answers alike
    cdb = interop.global_database_from_arrays(jdb.descriptor, jdb.labels, jdb.descs, jdb.views,
                                              jdb.poses)
    cr = tgp.recognize_clusters(cdb, clusters[:1], n_candidates=2, refine_iterations=20,
                                device="cpu")
    np.testing.assert_array_equal(cr[0].transform, tr[0].transform)


def test_esf_descriptor_matches_jax_on_its_draws():
    view = jgp.render_views(_sphere(0.08, n=1500), n_views=2, seed=1)[0]["xyz"]
    key = jax.random.PRNGKey(0)
    jc = jfrom(view)
    j = np.asarray(jfeatures.estimate_esf(jc, key))
    tri = torch.from_numpy(_jax_esf_draw(jc.mask, key))
    t = tgp._descriptor(tfrom(view, device="cpu"), "esf", tri=tri)
    assert t.shape == (640,)
    # samples with a distance shape function within 1e-5 of a bin edge, as
    # test_torch_global_desc.py counts them
    x = view.astype(np.float64)
    a, b, c = (x[i] for i in tri.numpy())
    scale = np.max(np.linalg.norm(x - x.mean(0), axis=1))
    d = [np.linalg.norm(p - q, axis=1) / (2 * scale) for p, q in ((a, b), (b, c), (c, a))]
    near = sum(F.near_grid(v * 64, 1e-5 * 64) for v in d + [(d[0] + d[1] + d[2]) / 3])
    assert np.abs(t - j).max() <= 1e-4 + 2 * 100.0 / 4096 * int((near > 0).sum())


def test_segment_scene_clusters_matches_jax():
    rng = np.random.default_rng(5)
    table = np.c_[rng.uniform(-1, 1, (3000, 2)), np.zeros(3000)].astype(np.float32)
    obj1 = _box([0.1, 0.1, 0.2], n=800) + np.float32([0.4, 0.3, 0.15])
    obj2 = _sphere(0.09, n=800) + np.float32([-0.4, -0.2, 0.12])
    pts = np.concatenate([table, obj1, obj2])
    jcl = jgp.segment_scene_clusters(jfrom(pts), plane_threshold=0.02, cluster_tolerance=0.08,
                                     min_cluster_size=100)
    tcl = tgp.segment_scene_clusters(tfrom(pts, device="cpu"), plane_threshold=0.02,
                                     cluster_tolerance=0.08, min_cluster_size=100,
                                     gen=torch.Generator().manual_seed(0))
    assert len(tcl) == len(jcl) == 2
    for a, b in zip(tcl, jcl):
        np.testing.assert_array_equal(np.sort(a, axis=0), np.sort(b, axis=0))
