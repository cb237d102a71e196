"""Parity of pcl_tpu_torch.registration.fpcs with the JAX package on the CPU.

The batched aligners run through their cores on the JAX package's own
``split``/``categorical``/``randint`` draws (ROADMAP C17); ``fpcs4_align_host``
draws on the host with ``np.random.default_rng(seed)``, the same draws as the
JAX package. Scores are truncated mean distances, which the JAX CPU 1-NN
forms from the matmul identity and the port exactly (C1): at an exact fit the
JAX error is the square root of that identity's rounding, up to
``sqrt(2^-22 * 2 * 3^2)`` = 2.1e-3 m on these clouds, so errors are compared
to 3e-3 and transforms to 1e-4 (the same Umeyama fit of the same points).

``fpcs4_align_host`` decides in float32 which target pairs match each base
and which intermediate points coincide, and each count feeds the next host
draw. The test records every pair length and match distance the port's
run decides on and checks that none lies within 1e-5 of its cut, so both
packages' decisions are the same; kernel B1 and the JAX package's kd-tree
may differ where two e1 points are equally near an e2 (ROADMAP C32)."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.core.transforms import se3_exp as jse3
from pcl_tpu.registration import fpcs as jf

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.registration import fpcs as tf

ERR_TOL = 3e-3
T_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """tests/test_golden_ia.py's synthetic 4PCS pair: a height field moved
    rigidly."""
    rng = np.random.default_rng(5)
    n = 400
    pts = np.column_stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                           0.3 * np.sin(rng.uniform(-3, 3, n))]).astype(np.float32)
    T = np.asarray(jse3(jnp.asarray(np.float32([0.4, -0.3, 0.2, 0.3, -0.2, 0.8]))))
    dst = (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    m = np.ones(n, bool)
    m[::13] = False
    jc = [JCloud(xyz=jnp.asarray(np.where(m[:, None], x, 0)), mask=jnp.asarray(m))
          for x in (pts, dst)]
    tc = [make_cloud(x, mask=m, device="cpu") for x in (pts, dst)]
    return jc, tc, T


def _logp(mask):
    p = jnp.asarray(mask).astype(jnp.float32)
    return jnp.log(p / jnp.maximum(jnp.sum(p), 1.0) + 1e-30)[None, :]


def _t(a):
    return torch.from_numpy(np.array(a))


def _compare(got, want, T=None):
    assert bool(got.valid) == bool(want.valid)
    assert float(got.error) == pytest.approx(float(want.error), abs=ERR_TOL)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=T_TOL)
    if T is not None:
        np.testing.assert_allclose(got.transform.numpy(), T, atol=0.2)


SMALL = dict(n_bases=32, n_target_sub=256, n_eval=128)


def _fpcs_draws(js, jt, key, nb=32, M=256, P=8, ne=128):
    kb, _, kt, kp, ke = jax.random.split(key, 5)
    tsub = jax.random.categorical(kt, _logp(jt.mask).repeat(M, 0)).astype(jnp.int32)
    tri = jax.random.categorical(kb, _logp(js.mask).repeat(nb * 3, 0)).reshape(nb, 3)
    pij = jax.random.randint(kp, (nb, P, 2), 0, M)
    sub = jax.random.categorical(ke, _logp(js.mask).repeat(ne, 0))
    return [_t(x.astype(jnp.int32)) for x in (tsub, tri, pij, sub)]


@pytest.mark.parametrize("seed,thr,delta,pairs,live", [
    pytest.param(0, None, 0.05, 8, True, id="0-None"),
    # no drawn pair matches a base within 0.05 m: every error is +inf
    pytest.param(3, 0.5, 0.05, 8, False, id="3-0.5"),
    pytest.param(3, 0.5, 0.1, 32, True, id="3-0.5-wide"),
])
def test_fpcs_core_matches_jax(pair, seed, thr, delta, pairs, live):
    """The best hypothesis and its score; ``live`` says whether the draws
    give a valid one, so the scoring is held on live hypotheses too."""
    (js, jt), (ts, tt), T = pair
    key = jax.random.PRNGKey(seed)
    want = jf.fpcs_align(js, jt, key=key, error_threshold=thr, delta=delta,
                         pairs_per_base=pairs, **SMALL)
    got = tf.fpcs_core(ts, tt, *_fpcs_draws(js, jt, key, P=pairs), delta=delta,
                       error_threshold=thr)
    assert bool(got.valid) == live
    _compare(got, want)


def _box():
    """The six faces of a 2 x 1.4 x 0.9 box (1 cm noise) and its moved copy:
    ISS finds keypoints along its edges and corners."""
    rng = np.random.default_rng(3)
    faces = []
    for axis in range(3):
        for side in (-1, 1):
            p = rng.uniform(-1, 1, size=(120, 3))
            p[:, axis] = side
            faces.append(p * np.float32([1.0, 0.7, 0.45]))
    tgt = (np.concatenate(faces) + rng.normal(scale=0.01, size=(720, 3))).astype(np.float32)
    T = np.asarray(jse3(jnp.asarray((0.1, -0.05, 0.08, 0.15, 0.1, -0.1), jnp.float32)))
    return ((tgt - T[:3, 3]) @ T[:3, :3]).astype(np.float32), tgt, T


def test_kfpcs_keypoints_and_core_match_jax():
    from pcl_tpu.keypoints.iss import iss3d_keypoints as jiss

    src, tgt, T = _box()
    js, jt = (JCloud(xyz=jnp.asarray(x), mask=jnp.ones(720, bool)) for x in (src, tgt))
    key = jax.random.PRNGKey(3)
    want = jf.kfpcs_align(js, jt, salient_radius=0.4, delta=0.05, key=key, **SMALL)
    ks, kt = tf.kfpcs_keypoints(make_cloud(src, device="cpu"), make_cloud(tgt, device="cpu"),
                                0.4)
    for c, jc in ((ks, js), (kt, jt)):
        np.testing.assert_array_equal(c.mask.numpy(),
                                      np.asarray(jiss(jc, 0.4, 0.2, density_weights=True)[0]))
        assert int(c.mask.sum()) >= 8
    jks, jkt = (JCloud(xyz=jnp.asarray(c.xyz.numpy()), mask=jnp.asarray(c.mask.numpy()))
                for c in (ks, kt))
    _compare(tf.fpcs_core(ks, kt, *_fpcs_draws(jks, jkt, key)), want)


def test_kfpcs_falls_back_without_keypoints():
    c = make_cloud(np.random.default_rng(0).uniform(-1, 1, size=(6, 3)), device="cpu")
    s, t = tf.kfpcs_keypoints(c, c, 0.3)
    assert s is c and t is c


def _fpcs4_draws(js, jt, key, nb=16, M=128, ne=128):
    k_tri, k_c4, k_tsub, k_eval = jax.random.split(key, 4)
    tri = jax.random.categorical(k_tri, _logp(js.mask).repeat(4 * nb * 3, 0)).reshape(4 * nb, 3)
    c4 = jax.random.categorical(k_c4, _logp(js.mask).repeat(nb * 32, 0)).reshape(nb, 32)
    tsub = jax.random.categorical(k_tsub, _logp(jt.mask).repeat(M, 0))
    sub = jax.random.categorical(k_eval, _logp(js.mask).repeat(ne, 0))
    return [_t(x.astype(jnp.int32)) for x in (tri, c4, tsub, sub)]


@pytest.mark.parametrize("seed,kw", [(0, dict(pairs_per_base=128, n_hyp=512)),
                                     (1, dict(pairs_per_base=64, n_hyp=256, overlap=0.9))])
def test_fpcs4_core_matches_jax(pair, seed, kw):
    (js, jt), (ts, tt), T = pair
    key = jax.random.PRNGKey(seed)
    want = jf.fpcs4_align(js, jt, key=key, n_bases=16, n_target_sub=128, n_eval=128, **kw)
    got = tf.fpcs4_core(ts, tt, *_fpcs4_draws(js, jt, key), **kw)
    _compare(got, want)


def test_top_k_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = tf._top_k(x, 3)
    j = jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1]
    np.testing.assert_array_equal(i.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 2])
def test_fpcs4_align_host_matches_jax(pair, seed, monkeypatch):
    """On the pair's first 100 points (a smaller pair table, so that with
    these seeds no decision lies within 1e-5 of its cut)."""
    (js, jt), _, T = pair
    x = [np.asarray(c.xyz)[np.asarray(c.mask)][:100] for c in (js, jt)]
    js, jt = (JCloud(xyz=jnp.asarray(a), mask=jnp.ones(100, bool)) for a in x)
    ts, tt = (make_cloud(a, device="cpu") for a in x)
    kw = dict(delta=0.05, overlap=0.9, n_bases=8, n_eval=128, seed=seed)
    lengths, hits = [], []
    base = tf._host_base
    nn1 = tf.bruteforce.nn1

    def spy_base(*a):
        out = base(*a)
        if out is not None:
            lengths.extend([np.linalg.norm(out[1] - out[0]), np.linalg.norm(out[3] - out[2])])
        return out

    def spy_nn1(*a):
        out = nn1(*a)
        hits.append(np.sqrt(np.maximum(out[1].numpy().astype(np.float64), 0.0)))
        return out

    monkeypatch.setattr(tf, "_host_base", spy_base)
    monkeypatch.setattr(tf.bruteforce, "nn1", spy_nn1)
    got = tf.fpcs4_align_host(ts, tt, **kw)
    monkeypatch.undo()
    want = jf.fpcs4_align_host(js, jt, **kw)
    # no decision within 1e-5 of its cut (float64 over the float32 values);
    # the last 1-NN sweep is the scoring's
    tx = x[1].astype(np.float64)
    plen = np.linalg.norm(tx[:, None] - tx[None], axis=-1)
    assert len(lengths) >= 8 and len(hits) >= 5
    for d in lengths:
        assert np.abs(np.abs(plen - float(d)) - 0.1).min() > 1e-5
    assert min(np.abs(h - 0.1).min() for h in hits[:-1]) > 1e-5
    _compare(got, want, T)


def test_fpcs4_align_host_without_bases():
    c = make_cloud(np.zeros((5, 3), np.float32), device="cpu")
    res = tf.fpcs4_align_host(c, c, n_bases=2)
    assert not bool(res.valid) and float(res.error) == float("inf")
