"""Parity of pcl_tpu_torch.registration.ppf with the JAX package on the CPU.

- ``ppf_features`` and ``_alpha`` to 1e-6 (arccos and atan2 of the same
  float32 dot products);
- ``_quantize`` bit for bit over features whose hash products wrap int32
  (``q4 * 67867967`` passes 2^31 from ``q4 = 32``, 1.6 m at 5 cm steps), and
  ``abs(INT_MIN) % n`` as int32 arithmetic gives it;
- ``ppf_core`` on the JAX package's own draws (ROADMAP C17) on
  tests/test_ppf.py's model: the same vote count and the pose to 1e-5."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import features as jfeat
from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.core.transforms import se3_exp as jse3
from pcl_tpu.registration import ppf as jp

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.registration import ppf as tp


def _pairs(seed=0, n=500):
    rng = np.random.default_rng(seed)
    p1, p2 = (rng.uniform(-2, 2, size=(n, 3)).astype(np.float32) for _ in range(2))
    n1, n2 = (rng.normal(size=(n, 3)) for _ in range(2))
    n1 = (n1 / np.linalg.norm(n1, axis=1, keepdims=True)).astype(np.float32)
    n2 = (n2 / np.linalg.norm(n2, axis=1, keepdims=True)).astype(np.float32)
    return p1, n1, p2, n2


def test_features_and_alpha():
    arrays = _pairs()
    fj = jp.ppf_features(*map(jnp.asarray, arrays))
    ft = tp.ppf_features(*map(torch.from_numpy, arrays))
    for a, b in zip(fj, ft):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    p1, n1, p2, _ = arrays
    n1[:10] = [1.0, 0.0, 0.0]                          # the other helper axis
    aj = np.asarray(jp._alpha(*map(jnp.asarray, (p1, n1, p2))))
    at = tp._alpha(*map(torch.from_numpy, (p1, n1, p2))).numpy()
    np.testing.assert_allclose(at, aj, atol=1e-6)


@pytest.mark.parametrize("dist_step", [0.05, 0.001])
def test_quantize_wraps_like_int32(dist_step):
    rng = np.random.default_rng(1)
    f = [rng.uniform(0, np.pi, 20000).astype(np.float32) for _ in range(3)]
    f.append(rng.uniform(0, 30, 20000).astype(np.float32))
    q4 = (f[3] / np.float32(dist_step)).astype(np.int64)
    assert (q4 * 67867967 > 2 ** 31).mean() > 0.5             # the products wrap
    want = np.asarray(jp._quantize(*map(jnp.asarray, f), np.pi / 15, dist_step, 1 << 16))
    got = tp._quantize(*map(torch.from_numpy, f), np.pi / 15, dist_step, 1 << 16).numpy()
    np.testing.assert_array_equal(got, want)


def test_abs_mod_of_int_min():
    h = np.array([-2 ** 31, -2 ** 31 + 1, -5, 0, 7, 2 ** 31 - 1], np.int32)
    for n in (1000, 1 << 16, 7):
        want = np.asarray(jnp.abs(jnp.asarray(h)) % jnp.int32(n))
        got = tp._abs_mod(torch.from_numpy(h.astype(np.int64)), n).numpy()
        np.testing.assert_array_equal(got, want)
    assert want[0] != (2 ** 31) % 7                     # abs(INT_MIN) stayed negative


@pytest.fixture(scope="module")
def clouds():
    """tests/test_ppf.py's asymmetric model and its moved copy, with the JAX
    package's normals on both sides."""
    rng = np.random.default_rng(42)
    n3 = 300
    a = np.stack([rng.uniform(0, 1, n3), rng.uniform(0, 2, n3),
                  0.3 * rng.uniform(0, 1, n3) ** 2], 1)
    b = np.stack([rng.uniform(0, 1, n3), np.zeros(n3), rng.uniform(0, 1, n3)], 1)
    model_pts = np.concatenate([a, b]).astype(np.float32)
    T = np.asarray(jse3(jnp.asarray([0.3, -0.2, 0.4, 0.0, 0.0, 0.8], jnp.float32)))
    scene_pts = (model_pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    out = {}
    for name, pts in (("model", model_pts), ("scene", scene_pts)):
        jc = jfeat.estimate_normals(jmake(jnp.asarray(pts)), k=12,
                                    viewpoint=jnp.asarray([0.0, 0, 100]))
        out[name] = (jc, make_cloud(pts, attrs={"normal": np.array(jc.attrs["normal"])},
                                    device="cpu"))
    return out, T


@pytest.mark.parametrize("seed,cap", [(1, 8), (2, 2)])
def test_ppf_core_matches_jax(clouds, seed, cap):
    (jm, tm), (js, ts) = clouds[0]["model"], clouds[0]["scene"]
    key = jax.random.PRNGKey(seed)
    kw = dict(dist_step=0.1, cap=cap)
    want = jp.ppf_register(jm, js, key=key, **kw)
    draws = []
    for c, k, count in zip((jm, js, js), jax.random.split(key, 3), (192, 32, 192)):
        probs = c.mask.astype(jnp.float32)
        probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
        draws.append(torch.from_numpy(np.array(jax.random.categorical(
            k, jnp.log(probs + 1e-30)[None, :].repeat(count, 0)).astype(jnp.int32))))
    got = tp.ppf_core(tm, ts, *draws, **kw)
    assert int(got.votes) == int(want.votes) and bool(got.valid) == bool(want.valid)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-5)


def test_ppf_register_runs_and_needs_normals(clouds):
    (_, tm), (_, ts) = clouds[0]["model"], clouds[0]["scene"]
    res = tp.ppf_register(tm, ts, dist_step=0.1)
    assert bool(res.valid) and int(res.votes) > 0
    with pytest.raises(ValueError):
        tp.ppf_register(tm.without_attrs("normal"), ts)
