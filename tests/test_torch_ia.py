"""Parity of pcl_tpu_torch.registration.ia (feature kNN, SAC-IA,
prerejective RANSAC) and validation with the JAX package on the CPU, on
tests/test_ia.py's scene.

The port cannot draw JAX's random streams, so the tests draw ``sidx``,
``pick`` and ``sub`` with the ``jax.random`` calls the JAX functions make for
a key and feed them, with the JAX package's feature candidates, to the
port's cores (ROADMAP C17). The JAX side's hypotheses are rebuilt from its
own pieces (``feature_knn``, ``geometry.umeyama``, ``ia._batched_nn_d2``),
checked against what its function returns, and compared hypothesis by
hypothesis:

- transforms to 1e-4 (the same Horn iteration in float32) where the fit is
  well posed: the top two eigenvalues of Horn's matrix lie more than 2% of
  its largest apart (a wrong match of two unlike triangles leaves them close,
  and the fixed number of power steps then ends where rounding takes it);
- on those hypotheses, SAC-IA errors to 2e-4: the JAX CPU 1-NN returns the
  matmul-identity distance and the port the exact one (ROADMAP C1), and the
  square root of a small distance magnifies the difference; prerejective
  inlier fractions to 4 of the 128 subset points (points within the
  distance difference of the gate);
- the same best hypothesis wherever it is well posed and the top two scores
  lie further apart than twice those tolerances.

Feature kNN: indices equal except where two listed distances lie within
1e-3 (descriptors of norm ~100, whose matrix products round differently).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import features as jfeat
from pcl_tpu.core import geometry as jgeom
from pcl_tpu.core import transforms as jtf
from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.registration import validation as jval

from pcl_tpu_torch.core.cloud import make_cloud as tmake
from pcl_tpu_torch.registration import ia as tia
from pcl_tpu_torch.registration import validation as tval

jia = importlib.import_module("pcl_tpu.registration.ia")

BIG_XI = np.array([0.5, -0.3, 0.4, 0.0, 0.0, 1.2], np.float32)     # ~69 deg yaw


def _scene(rng, n=600):
    """tests/test_ia.py's asymmetric scene."""
    n3 = n // 3
    a = np.stack([rng.uniform(0, 2, n3), rng.uniform(0, 1, n3),
                  0.2 * rng.uniform(0, 2, n3) ** 2], 1)
    b = np.stack([rng.uniform(0, 1, n3), np.zeros(n3), rng.uniform(0, 1, n3)], 1)
    t = rng.uniform(0, 2, n - 2 * n3)
    c = np.stack([t, 0.5 + 0.3 * np.sin(3 * t), 0.5 * t], 1)
    pts = np.concatenate([a, b, c]).astype(np.float32)
    return pts + rng.normal(scale=0.005, size=pts.shape).astype(np.float32)


@pytest.fixture(scope="module")
def prepared():
    """Source and target clouds and the JAX package's FPFH of each, on both
    sides."""
    rng = np.random.default_rng(42)
    tgt = _scene(rng)
    T_true = np.asarray(jtf.se3_exp(jnp.asarray(BIG_XI)))
    src = ((tgt - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    out = {"T": T_true}
    for name, pts in (("src", src), ("tgt", tgt)):
        jc = jmake(jnp.asarray(pts), capacity=640)
        jn = jfeat.estimate_normals(jc, k=12, viewpoint=jnp.asarray([0.0, 0, 100]))
        f = np.asarray(jfeat.estimate_fpfh(jn, k=16))
        out[name] = (jc, tmake(pts, capacity=640, device="cpu"), f)
    return out


def _draws(key, n_hyp, m, k_corr, n_eval, mask):
    """``sidx``, ``pick``, ``sub`` as pcl_tpu.registration.ia draws them."""
    probs = jnp.asarray(mask).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    k_smp, k_pick, k_sub = jax.random.split(key, 3)
    sidx = jax.random.categorical(
        k_smp, jnp.log(probs + 1e-30)[None, :].repeat(n_hyp * m, 0)).reshape(n_hyp, m)
    pick = jax.random.randint(k_pick, (n_hyp, m), 0, k_corr)
    sub = jax.random.categorical(k_sub, jnp.log(probs + 1e-30)[None, :].repeat(n_eval, 0))
    return sidx.astype(jnp.int32), pick, sub.astype(jnp.int32)


def _jax_hypotheses(jsrc, jtgt, cand, sidx, pick, sub):
    """The JAX package's transforms and subset squared distances."""
    n_hyp, m = sidx.shape
    tidx = jnp.take_along_axis(cand[sidx].reshape(n_hyp, m, -1), pick[..., None], axis=-1)[..., 0]
    src_s, tgt_s = jsrc.xyz[sidx], jtgt.xyz[jnp.clip(tidx, 0, jtgt.capacity - 1)]
    Ts = jgeom.umeyama(src_s, tgt_s, jnp.ones((n_hyp, m), jnp.float32))
    d2 = jia._batched_nn_d2(Ts, jsrc.xyz[sub], jtgt.xyz, jtgt.mask)
    return np.asarray(Ts), np.asarray(d2), _horn_gap(src_s, tgt_s) > 0.02


def _horn_gap(src_s, tgt_s):
    """Relative gap between the top two eigenvalues of Horn's 4x4 matrix of
    each sample (float64)."""
    s, t = (np.asarray(a, np.float64) for a in (src_s, tgt_s))
    H = np.einsum("bni,bnj->bij", t - t.mean(1, keepdims=True), s - s.mean(1, keepdims=True))
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = (
        [H[:, i, j] for j in range(3)] for i in range(3))
    K = np.stack([np.stack([xx + yy + zz, zy - yz, xz - zx, yx - xy], -1),
                  np.stack([zy - yz, xx - yy - zz, xy + yx, zx + xz], -1),
                  np.stack([xz - zx, xy + yx, -xx + yy - zz, yz + zy], -1),
                  np.stack([yx - xy, zx + xz, yz + zy, -xx - yy + zz], -1)], -2)
    lam = np.linalg.eigvalsh(K)
    return (lam[:, 3] - lam[:, 2]) / np.maximum(np.abs(lam).max(1), 1e-12)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_feature_knn_matches_jax(prepared):
    (jsrc, tsrc, fs), (jtgt, ttgt, ft) = prepared["src"], prepared["tgt"]
    smask = np.asarray(jsrc.mask).copy()
    smask[:5] = False                           # masked source rows list 0 .. k-1
    want = np.asarray(jia.feature_knn(jnp.asarray(fs), jnp.asarray(smask), jnp.asarray(ft),
                                      jtgt.mask, 5))
    old = tia._CHUNK_ELEMS
    tia._CHUNK_ELEMS = 640 * 100                 # several source chunks
    try:
        got = tia.feature_knn(*_torch(fs, smask, ft), ttgt.mask, 5).numpy()
    finally:
        tia._CHUNK_ELEMS = old
    assert got.dtype == np.int32 and got.shape == (640, 5)
    np.testing.assert_array_equal(got[:5], np.tile(np.arange(5), (5, 1)))
    d = ((fs[:, None, :] - ft[None, :, :]) ** 2).sum(-1)
    dl = np.take_along_axis(d, want.astype(np.int64), axis=1)
    near = np.zeros_like(got, bool)
    gap = np.abs(np.diff(dl, axis=1)) <= 1e-3
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    ok = ~near & smask[:, None]
    assert ok.mean() > 0.8
    np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("seed", [3, 5])
def test_sac_ia_core_matches_jax(prepared, seed):
    (jsrc, tsrc, fs), (jtgt, ttgt, ft) = prepared["src"], prepared["tgt"]
    key = jax.random.PRNGKey(seed)
    want = jia.sac_ia(jsrc, jnp.asarray(fs), jtgt, jnp.asarray(ft), key=key, n_hypotheses=128,
                      n_eval=128)
    cand = jia.feature_knn(jnp.asarray(fs), jsrc.mask, jnp.asarray(ft), jtgt.mask, 10)
    sidx, pick, sub = _draws(key, 128, 3, 10, 128, jsrc.mask)
    Ts_j, d2_j, firm = _jax_hypotheses(jsrc, jtgt, cand, sidx, pick, sub)
    span = np.asarray(jtgt.xyz)[:600].max(0) - np.asarray(jtgt.xyz)[:600].min(0)
    thr = 0.25 * np.linalg.norm(span)
    errs_j = np.minimum(np.sqrt(np.maximum(d2_j, 0.0)), thr).mean(1)
    np.testing.assert_allclose(np.asarray(want.transform), Ts_j[np.argmin(errs_j)], atol=1e-6)

    Ts, errs = tia.sac_ia_scores(tsrc, ttgt, *_torch(cand, sidx, pick, sub))
    np.testing.assert_allclose(Ts.numpy()[firm], Ts_j[firm], atol=1e-4)
    np.testing.assert_allclose(errs.numpy()[firm], errs_j[firm], atol=2e-4)
    got = tia.sac_ia_core(tsrc, ttgt, *_torch(cand, sidx, pick, sub))
    top2 = np.sort(errs_j)[:2]
    if top2[1] - top2[0] > 4e-4 and firm[np.argmin(errs_j)]:
        np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)
    assert bool(got.valid) and abs(float(got.error) - float(want.error)) <= 2e-4


@pytest.mark.parametrize("seed", [4, 6])
def test_prerejective_core_matches_jax(prepared, seed):
    (jsrc, tsrc, fs), (jtgt, ttgt, ft) = prepared["src"], prepared["tgt"]
    key = jax.random.PRNGKey(seed)
    want = jia.prerejective_ransac(jsrc, jnp.asarray(fs), jtgt, jnp.asarray(ft), key=key,
                                   inlier_threshold=0.1, n_hypotheses=256, n_eval=128)
    cand = jia.feature_knn(jnp.asarray(fs), jsrc.mask, jnp.asarray(ft), jtgt.mask, 5)
    sidx, pick, sub = _draws(key, 256, 3, 5, 128, jsrc.mask)
    Ts_j, d2_j, firm = _jax_hypotheses(jsrc, jtgt, cand, sidx, pick, sub)
    Ts, score = tia.prerejective_scores(tsrc, ttgt, *_torch(cand, sidx, pick, sub),
                                        inlier_threshold=0.1)
    ok = np.isfinite(score.numpy())
    assert ok.sum() > 5
    np.testing.assert_allclose(Ts.numpy()[firm & ok], Ts_j[firm & ok], atol=1e-4)
    score_j = (d2_j <= np.float32(0.1 ** 2)).mean(1)
    np.testing.assert_allclose(score.numpy()[ok & firm], score_j[ok & firm], atol=4 / 128)
    best_j = np.argmax(np.where(ok, score_j, -np.inf))
    np.testing.assert_allclose(np.asarray(want.transform), Ts_j[best_j], atol=1e-6)
    got = tia.prerejective_core(tsrc, ttgt, *_torch(cand, sidx, pick, sub),
                                inlier_threshold=0.1)
    top2 = np.sort(np.where(ok, score_j, -np.inf))[-2:]
    if top2[1] - top2[0] > 8 / 128 and firm[best_j]:
        np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)
    assert bool(got.valid) and abs(float(got.error) - float(want.error)) <= 4 / 128


def test_samplers_and_public_functions(prepared):
    (jsrc, tsrc, fs), (jtgt, ttgt, ft) = prepared["src"], prepared["tgt"]
    sidx, pick, sub = tia.draw_ia_samples(tsrc.mask, 300, 3, 5, 100)
    assert sidx.shape == pick.shape == (300, 3) and sub.shape == (100,)
    assert tsrc.mask[sidx.long()].all() and tsrc.mask[sub.long()].all()
    assert int(pick.min()) >= 0 and int(pick.max()) == 4
    again = tia.draw_ia_samples(tsrc.mask, 300, 3, 5, 100)
    assert all(torch.equal(a, b) for a, b in zip((sidx, pick, sub), again))
    tfs, tft = _torch(fs, ft)
    T = prepared["T"]
    res = tia.prerejective_ransac(tsrc, tfs, ttgt, tft, inlier_threshold=0.1, n_hypotheses=512,
                                  n_eval=128)
    assert bool(res.valid)
    res = tia.sac_ia(tsrc, tfs, ttgt, tft, n_hypotheses=128, n_eval=128)
    assert bool(res.valid) and np.isfinite(res.transform.numpy()).all()
    assert T.shape == (4, 4)


@pytest.mark.parametrize("max_range,threshold", [(float("inf"), float("inf")), (0.05, 1e-3)])
def test_validate_euclidean_matches_jax(prepared, max_range, threshold):
    (jsrc, tsrc, _), (jtgt, ttgt, _) = prepared["src"], prepared["tgt"]
    for T in (prepared["T"], np.eye(4)):
        T = T.astype(np.float32)
        want = jval.validate_euclidean(jsrc, jtgt, jnp.asarray(T), max_range=max_range,
                                       threshold=threshold)
        got = tval.validate_euclidean(tsrc, ttgt, torch.from_numpy(T), max_range=max_range,
                                      threshold=threshold)
        # the exact 1-NN distance against the matmul identity (ROADMAP C1)
        np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-4, atol=1e-6)
        assert bool(got.is_valid) == bool(want.is_valid)
        assert abs(int(got.num_inliers) - int(want.num_inliers)) <= 1
