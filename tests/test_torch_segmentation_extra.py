"""Parity of the rest of the port's ``segmentation/`` and ``ml.kmeans`` with
the JAX package on the CPU: organized connected components, multi-plane
segmentation and polygonal prisms; supervoxels; LCCP, CPC, seeded hue, the
random walker and the unary classifier; min-cut, max-flow and GrabCut.

Tolerances:
- Organized labels, supervoxel labels, LCCP/CPC, seeded hue, prisms, the
  cuts: equal. The organized flood reaches the JAX package's fixed point by
  pointer jumping with a read-back every few sweeps (ROADMAP C59).
- Plane coefficients and supervoxel centres to 1e-6.
- Min-cut (C58): capacities scaled by 1e4 within 1 of each other and
  rounded to the same integer unless they lie within 1e-3 of a half; the cut
  equal when every capacity rounds alike (the count of near-halves and of
  capacities rounded apart is printed).
- Random walker (C60): labels equal where the port's top two probabilities
  differ by more than 1e-4 (the packages' CG may stop an iteration apart).
- K-means and the unary classifier run their cores on the JAX package's own
  draws (C17, C61): centroids to 1e-5, labels equal.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_surface_scenes as S
from pcl_tpu.segmentation import advanced as jad
from pcl_tpu.segmentation import graphcut as jgc
from pcl_tpu.segmentation import organized as jor
from pcl_tpu.segmentation import supervoxel as jsv

from pcl_tpu_torch.segmentation import advanced as tad
from pcl_tpu_torch.segmentation import graphcut as tgc
from pcl_tpu_torch.segmentation import organized as tor
from pcl_tpu_torch.segmentation import supervoxel as tsv

jkm = importlib.import_module("pcl_tpu.ml.kmeans")
tkm = importlib.import_module("pcl_tpu_torch.ml.kmeans")

CAP = 1536


def _a(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def scene():
    xyz, nrm, rgb = S.sphere_on_floor(0)
    return (xyz, nrm, rgb) + S.clouds(xyz, nrm, rgb, capacity=CAP)


@pytest.fixture(scope="module")
def supervoxels(scene):
    *_, jc, tc = scene
    return jsv.supervoxel_clustering(jc, 0.15), tsv.supervoxel_clustering(tc, 0.15)


def _organized_frame(seed=0, H=30, W=40):
    """A floor seen from above and a 45-degree ramp beside it, with some
    holes: ``(xyz [H, W, 3], normals, valid)``."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W]
    ramp = u >= W // 2
    z = np.where(ramp, 1.0 + 0.01 * (u - W // 2), 1.0) + 1e-4 * rng.normal(size=(H, W))
    xyz = np.stack([(u - W // 2) * 0.01, (v - H // 2) * 0.01, z], -1).astype(np.float32)
    n = np.where(ramp[..., None], np.array([1.0, 0.0, -1.0]) / np.sqrt(2), [0.0, 0.0, -1.0])
    valid = rng.uniform(size=(H, W)) > 0.05
    return xyz, n.astype(np.float32), valid


def test_organized_connected_components_match_jax():
    xyz, _, valid = _organized_frame()
    xyz[:, 12] += np.array([0, 0, 0.1], np.float32)        # a step cuts the floor in two
    lj = np.asarray(jor.organized_connected_components(jnp.asarray(xyz), jnp.asarray(valid), 0.02))
    lt = _a(tor.organized_connected_components(xyz, valid, 0.02, device="cpu"))
    assert np.array_equal(lt, lj) and len(np.unique(lj[lj >= 0])) >= 3


def test_propagate_min_labels_reaches_the_flood_fixed_point():
    """A snake through the whole image (hundreds of sweeps for a plain flood)
    ends with every pixel at its component's smallest index."""
    H, W = 24, 24
    valid = np.zeros((H, W), bool)
    valid[::2, :] = True
    valid[1::4, -1] = True
    valid[3::4, 0] = True
    adj = np.zeros((H, W, 4), bool)
    for i, (dy, dx) in enumerate(((1, 0), (-1, 0), (0, 1), (0, -1))):
        nb = np.roll(valid, (dy, dx), (0, 1))
        ok = valid & nb
        if dy == 1:
            ok[0] = False
        if dy == -1:
            ok[-1] = False
        if dx == 1:
            ok[:, 0] = False
        if dx == -1:
            ok[:, -1] = False
        adj[..., i] = ok
    lt = _a(tor.propagate_min_labels(torch.from_numpy(adj), torch.from_numpy(valid)))
    lj = np.asarray(jor._propagate_min_labels(jnp.asarray(adj), jnp.asarray(valid), 256))
    assert np.array_equal(lt, lj) and set(np.unique(lt)) == {-1, 0}


def test_organized_multi_plane_segmentation_matches_jax():
    xyz, n, valid = _organized_frame()
    lj, rj = jor.organized_multi_plane_segmentation(xyz, n, valid, min_inliers=50)
    lt, rt = tor.organized_multi_plane_segmentation(xyz, n, valid, min_inliers=50, device="cpu")
    assert np.array_equal(lt, lj) and len(rt) == len(rj) == 2
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.coefficients, b.coefficients, atol=1e-6)
        np.testing.assert_allclose(a.centroid, b.centroid, atol=1e-6)
        assert np.array_equal(a.indices, b.indices) and a.count == b.count


def test_extract_polygonal_prism_matches_jax(scene):
    *_, jc, tc = scene
    hull = np.array([[-0.35, 0, -0.35], [0.35, 0, -0.3], [0.3, 0, 0.35], [-0.3, 0, 0.3]],
                    np.float32)
    for lo, hi in ((0.01, 0.7), (-0.01, 0.01)):
        pj = jor.extract_polygonal_prism(jc, hull, np.array([0, 1, 0, 0.0]), lo, hi)
        pt = tor.extract_polygonal_prism(tc, hull, np.array([0, 1, 0, 0.0]), lo, hi)
        assert np.array_equal(pt, pj) and pt.sum() > 100


def test_supervoxel_clustering_matches_jax(supervoxels):
    sj, st = supervoxels
    assert np.array_equal(_a(st.labels), np.asarray(sj.labels))
    assert np.array_equal(_a(st.center_valid), np.asarray(sj.center_valid))
    np.testing.assert_allclose(_a(st.centers), np.asarray(sj.centers), atol=1e-6)
    np.testing.assert_allclose(_a(st.normals), np.asarray(sj.normals), atol=1e-6)
    assert len(np.unique(_a(st.labels))) > 20


def test_lccp_and_cpc_match_jax(scene, supervoxels):
    *_, jc, tc = scene
    sj, st = supervoxels
    for a, b in zip(tad.lccp_segmentation(st), jad.lccp_segmentation(sj)):
        assert np.array_equal(a, b)
    for a, b in zip(tad.lccp_segmentation(st, min_segment_size=50),
                    jad.lccp_segmentation(sj, min_segment_size=50)):
        assert np.array_equal(a, b)
    ct, cj = tad.cpc_segmentation(tc, st), jad.cpc_segmentation(jc, sj)
    assert np.array_equal(ct, cj) and len(np.unique(cj)) >= 3


def test_seeded_hue_segmentation_matches_jax(scene):
    *_, jc, tc = scene
    seed = np.zeros(CAP, bool)
    seed[[0, 5]] = True
    hj = np.asarray(jad.seeded_hue_segmentation(jc, jnp.asarray(seed), 0.1))
    ht = _a(tad.seeded_hue_segmentation(tc, torch.from_numpy(seed), 0.1))
    assert np.array_equal(ht, hj) and hj.sum() == 600


def test_random_walker_matches_jax(scene):
    *_, jc, tc = scene
    sl = -np.ones(CAP, np.int32)
    sl[[0, 300]] = 0
    sl[[700, 1200]] = 1
    kw = dict(n_labels=2, sigma=0.05, cg_iters=300)
    rj = np.asarray(jad.random_walker(jc, jnp.asarray(sl), **kw))
    rt = _a(tad.random_walker(tc, torch.from_numpy(sl), **kw))
    P = np.sort(_a(tad.walker_probabilities(tc, torch.from_numpy(sl), **kw)), axis=0)
    firm = P[-1] - P[-2] > 1e-4
    print(f"random walker: {int((~firm[:1500]).sum())} of 1500 points near a tie")
    assert np.array_equal(rt[firm], rj[firm]) and (rt[:600] == 0).all()
    assert (rt[600:1500] == 1).sum() > 150


def test_min_cut_matches_jax(scene):
    xyz, *_, jc, tc = scene
    center = np.array([0.0, 0.3, 0.0], np.float32)
    kw = dict(sigma=0.03, radius=0.45, k=10)
    wj = jgc._mincut_weights(jc.xyz, jc.mask, jnp.asarray(center), jnp.float32(0.03),
                             jnp.float32(0.45), jnp.float32(0.8), 10)
    wt = tgc.mincut_weights(tc.xyz, tc.mask, center, 0.03, 0.45, 0.8, 10)
    assert np.array_equal(_a(wt[0]), np.asarray(wj[0]))
    caps = [(np.asarray(a, np.float64) * 1e4, _a(b).astype(np.float64) * 1e4)
            for a, b in zip(wj[1:], wt[1:])]
    near_half = [np.abs(np.abs(a - np.floor(a)) - 0.5) < 1e-3 for a, _ in caps]
    rounded_apart = sum(int((np.rint(a) != np.rint(b)).sum()) for a, b in caps)
    print(f"min-cut: {sum(int(h.sum()) for h in near_half)} scaled capacities within 1e-3 of "
          f"a half, {rounded_apart} rounded apart")
    for (a, b), h in zip(caps, near_half):
        assert np.abs(a - b).max() <= 1.0
        assert np.array_equal(np.rint(a)[~h], np.rint(b)[~h])
    mj = jgc.min_cut_segmentation(jc, center, **kw)
    mt = tgc.min_cut_segmentation(tc, center, **kw)
    if rounded_apart == 0:          # the same integer graph: the same cut
        assert np.array_equal(mt, mj)
    assert (mt != mj).sum() <= rounded_apart and mt[:600].all() and mt.sum() < 700


def test_max_flow_binary_labels_is_the_jax_copy():
    rng = np.random.default_rng(9)
    n = 40
    u, v = rng.integers(0, n, 120), rng.integers(0, n, 120)
    args = (n, u, v, rng.uniform(0, 1, 120), rng.uniform(0, 2, n), rng.uniform(0, 2, n))
    assert np.array_equal(tgc.max_flow_binary_labels(*args), jgc.max_flow_binary_labels(*args))


def test_grab_cut_matches_jax(scene):
    *_, jc, tc = scene
    init = np.zeros(CAP, bool)
    init[:700] = True
    gj, gt = jgc.grab_cut(jc, init), tgc.grab_cut(tc, init)
    assert np.array_equal(gt, gj) and gt[:600].all()


def _jax_draw(n, k, key=None):
    """The JAX package's k-means draw (``kmeans.py:32``) over ``n`` valid rows."""
    probs = jnp.ones(n) / n
    key = jax.random.PRNGKey(0) if key is None else key
    return np.array(jax.random.categorical(key, jnp.log(probs + 1e-30)[None, :].repeat(k, 0)))


def test_kmeans_core_matches_jax_on_its_draw(scene):
    _, _, rgb, *_ = scene
    m = np.ones(len(rgb), bool)
    m[::17] = False
    key = jax.random.PRNGKey(3)
    cj, lj, ij = jkm.kmeans(jnp.asarray(rgb), jnp.asarray(m), 4, key=key)
    w = m.astype(np.float32)
    init = np.array(jax.random.categorical(
        key, jnp.log(jnp.asarray(w / w.sum()) + 1e-30)[None, :].repeat(4, 0)))
    ct, lt, it = tkm.kmeans_core(torch.from_numpy(rgb), torch.from_numpy(m), 4,
                                 torch.from_numpy(init))
    np.testing.assert_allclose(_a(ct), np.asarray(cj), atol=1e-5)
    assert np.array_equal(_a(lt), np.asarray(lj)) and it == int(ij)
    drawn = tkm.kmeans_init_indices(torch.from_numpy(m), 64, torch.Generator().manual_seed(0))
    assert m[_a(drawn)].all()


def test_unary_classifier_matches_jax(scene):
    _, _, rgb, *_ = scene
    feats = [rgb[:600], rgb[600:]]
    cj = jad.UnaryClassifier().train(feats, clusters_per_class=3)
    init = [_jax_draw(len(f), 3) for f in feats]
    ct = tad.UnaryClassifier().train(feats, clusters_per_class=3, init_indices=init, device="cpu")
    np.testing.assert_allclose(ct.centroids, cj.centroids, atol=1e-5)
    assert np.array_equal(ct.class_of, cj.class_of)
    assert np.array_equal(ct.segment(rgb), cj.segment(rgb))
    assert (ct.segment(rgb)[:600] == 0).all()
