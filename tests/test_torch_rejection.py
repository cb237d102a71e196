"""Parity of pcl_tpu_torch.registration.rejection (and
``correspondence_normal_shooting``) with the JAX package on the CPU.

Every rejector returns ``Correspondences`` with ``valid`` tightened; the
masks are compared exactly (the inputs keep squared distances apart from the
thresholds). The median of an even count of valid pairs averages the two
middle values (ROADMAP C16). The random rejectors run their core on the
indices the JAX package draws for the same key (ROADMAP C17).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.registration import correspondence as jcorr
from pcl_tpu.registration import rejection as jrej

from pcl_tpu_torch.registration import correspondence as tcorr
from pcl_tpu_torch.registration import rejection as trej

jransac = importlib.import_module("pcl_tpu.sac.ransac")


def _corr(seed, n=400, m=300, dup_targets=True):
    rng = np.random.default_rng(seed)
    index = rng.integers(0, m, n).astype(np.int32)
    if dup_targets:
        index[50:80] = index[:30]                 # shared targets
    sqdist = rng.uniform(0, 1, n).astype(np.float32)
    sqdist[100:110] = sqdist[90]                  # exact ties
    valid = rng.random(n) < 0.85
    valid[:3] = True
    return index, sqdist, valid


def _both(index, sqdist, valid):
    j = jcorr.Correspondences(jnp.asarray(index), jnp.asarray(sqdist), jnp.asarray(valid))
    t = tcorr.Correspondences(torch.from_numpy(index), torch.from_numpy(sqdist),
                              torch.from_numpy(valid))
    return j, t


def _same(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))


@pytest.mark.parametrize("seed", [0, 1])
def test_distance_median_trimmed_match_jax(seed):
    index, sqdist, valid = _corr(seed)
    if valid.sum() % 2 != seed:                   # seed 0: an even count of valid pairs
        valid[np.nonzero(valid)[0][-1]] = False
    j, t = _both(index, sqdist, valid)
    _same(trej.reject_distance(t, 0.7), jrej.reject_distance(j, 0.7))
    for factor in (1.0, 0.5):
        _same(trej.reject_median_distance(t, factor), jrej.reject_median_distance(j, factor))
    for ratio in (0.5, 0.33, 1e-6):
        _same(trej.reject_trimmed(t, ratio), jrej.reject_trimmed(j, ratio))


def test_median_of_an_even_count_averages():
    index = np.zeros(4, np.int32)
    sqdist = np.float32([1.0, 4.0, 2.0, 3.0])
    j, t = _both(index, sqdist, np.ones(4, bool))
    got = trej.reject_median_distance(t)          # median 2.5: keeps 1 and 2
    _same(got, jrej.reject_median_distance(j))
    assert got.valid.tolist() == [True, False, True, False]


@pytest.mark.parametrize("seed,past_n", [(2, False), (3, True)])
def test_one_to_one_matches_jax(seed, past_n):
    """Shared targets, exact ties (the first source wins) and, with
    ``past_n``, target indices past the source count, which the JAX
    package's segments do not reach (ROADMAP C18)."""
    index, sqdist, valid = _corr(seed, n=200, m=400 if past_n else 150)
    sqdist[50:80] = sqdist[:30]
    j, t = _both(index, sqdist, valid)
    got = trej.reject_one_to_one(t)
    _same(got, jrej.reject_one_to_one(j))
    if past_n:
        assert not got.valid[torch.from_numpy(index) > 200].any()


def test_surface_normals_match_jax():
    rng = np.random.default_rng(4)
    index, sqdist, valid = _corr(4)
    sn = rng.normal(size=(400, 3)).astype(np.float32)
    tn = rng.normal(size=(300, 3)).astype(np.float32)
    sn /= np.linalg.norm(sn, axis=1, keepdims=True)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    j, t = _both(index, sqdist, valid)
    _same(trej.reject_surface_normals(t, torch.from_numpy(sn), torch.from_numpy(tn), 0.3),
          jrej.reject_surface_normals(j, jnp.asarray(sn), jnp.asarray(tn), 0.3))


def _registration_pair(seed, n=400, bad=120):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    a = 0.4
    R = np.float32([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    tgt = (src @ R.T + np.float32([0.5, -0.2, 0.1])).astype(np.float32)
    index = np.arange(n, dtype=np.int32)
    index[:bad] = rng.permutation(n)[:bad]        # wrong correspondences
    valid = rng.random(n) < 0.95
    return src, tgt, index, valid


def test_sample_consensus_matches_jax():
    src, tgt, index, valid = _registration_pair(5)
    sqdist = np.zeros(len(index), np.float32)
    j, t = _both(index, sqdist, valid)
    key = jax.random.PRNGKey(7)
    want = jrej.reject_sample_consensus(j, jnp.asarray(src), jnp.asarray(tgt), 0.05,
                                        n_hypotheses=64, key=key)
    # the draws pcl_tpu.sac.ransac makes for this key
    w = jnp.asarray(valid).astype(jnp.float32)
    k_idx, _ = jax.random.split(key)
    idx = jransac._sample_indices(k_idx, 64, 3, len(valid), w / jnp.maximum(jnp.sum(w), 1.0))
    got = trej.reject_sample_consensus_core(t, torch.from_numpy(src), torch.from_numpy(tgt),
                                            torch.from_numpy(np.asarray(idx)), 0.05)
    _same(got, want)
    wrong = np.arange(len(index)) != index
    assert not got.valid.numpy()[wrong & (np.abs(src - tgt).sum(1) > 0.5)].any()
    # the port's own sampler finds the same inliers
    own = trej.reject_sample_consensus(t, torch.from_numpy(src), torch.from_numpy(tgt), 0.05,
                                       n_hypotheses=64)
    np.testing.assert_array_equal(own.valid.numpy(), got.valid.numpy())


def test_polygon_matches_jax():
    src, tgt, index, valid = _registration_pair(6)
    j, t = _both(index, np.zeros(len(index), np.float32), valid)
    key = jax.random.PRNGKey(8)
    want = jrej.reject_polygon(j, jnp.asarray(src), jnp.asarray(tgt), iterations=200, key=key)
    probs = jnp.asarray(valid).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.categorical(key, jnp.log(probs + 1e-30)[None, :].repeat(600, 0)
                                 ).reshape(200, 3).astype(jnp.int32)
    got = trej.reject_polygon_core(t, torch.from_numpy(src), torch.from_numpy(tgt),
                                   torch.from_numpy(np.asarray(idx)))
    _same(got, want)
    own = trej.reject_polygon(t, torch.from_numpy(src), torch.from_numpy(tgt), iterations=200)
    assert own.valid.shape == got.valid.shape and (own.valid <= t.valid).all()


def test_normal_shooting_matches_jax():
    rng = np.random.default_rng(9)
    tgt = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    tm = rng.random(500) < 0.9
    src = rng.uniform(-1, 1, size=(200, 3)).astype(np.float32)
    sm = rng.random(200) < 0.9
    sn = rng.normal(size=(200, 3)).astype(np.float32)
    want = jcorr.correspondence_normal_shooting(jnp.asarray(src), jnp.asarray(sm),
                                                jnp.asarray(sn), jnp.asarray(tgt),
                                                jnp.asarray(tm), k=8, max_dist=0.3)
    got = tcorr.correspondence_normal_shooting(torch.from_numpy(src), torch.from_numpy(sm),
                                               torch.from_numpy(sn), torch.from_numpy(tgt),
                                               torch.from_numpy(tm), k=8, max_dist=0.3)
    # brute kNN distances are bitwise those of the JAX package (3-D)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_allclose(got.sqdist.numpy(), np.asarray(want.sqdist), rtol=1e-6)
