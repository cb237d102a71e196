"""Parity of the port's ``tracking`` (the particle filter, the KLD-adaptive
filter, pyramidal KLT) and ``keypoints.corners2d`` with the JAX package on
the CPU.

Tolerances:
- The trackers run their cores on the JAX package's own draws, redrawn with
  its ``split``/``normal``/``categorical``/``uniform`` calls (ROADMAP C17),
  from the JAX state of each step (``interop``). Scores differ by kernel
  B1's exact distance against the JAX CPU path's matmul identity (C1), so
  the weights round apart: the MAP pose to 1e-4, and the resampled
  particles row by row to 1e-4, every row but those whose sample point lies
  within 1e-4 of a cumulative-weight edge in float64 (counted: such a row
  may take the neighbouring parent, and XLA's and torch's float32 ``cumsum``
  add in different orders). The KLD filter's live count equal (an integer
  rule on the same particles).
- ``systematic_resample`` alone on the same weights and offset: parents
  equal wherever the sample point lies more than 1e-6 from an edge.
- KLT: displacements to 1e-3 px, status equal, away from the image border.
- AGAST's score and maxima, BRISK's keypoints and bits and Trajkovic's
  keypoints on an 8-bit image: equal (integer decisions on sums that are
  exact or rounded alike); Trajkovic's score to 1e-6 of its largest value.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.keypoints import corners2d as jc2d
from pcl_tpu.tracking import kld as jkld
from pcl_tpu.tracking import klt as jklt
from pcl_tpu.tracking import particle_filter as jpf

from pcl_tpu_torch import interop
from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.keypoints import corners2d as tc2d
from pcl_tpu_torch.tracking import kld as tkld
from pcl_tpu_torch.tracking import klt as tklt
from pcl_tpu_torch.tracking import particle_filter as tpf


def jax_draws(key, P, ref_mask, n_ref):
    """The draws the JAX step makes from ``key``, and the key it passes on."""
    k_noise, k_res, k_sub, k_next = jax.random.split(key, 4)
    noise = jax.random.normal(k_noise, (P, 6))
    probs = jnp.asarray(ref_mask, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    sub = jax.random.categorical(k_sub, jnp.log(probs + 1e-30)[None, :].repeat(n_ref, 0))
    u0 = jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / P)
    draws = tpf.StepDraws(*(torch.from_numpy(np.array(x)) for x in (noise, sub, u0)))
    return draws, k_next


def near_edges(w, u0, margin):
    """The sample points of systematic resampling within ``margin`` of a
    cumulative-weight edge (float64)."""
    w = np.asarray(w, np.float64)
    P = len(w)
    cum = np.cumsum(w) / w.sum()
    pts = float(u0) + np.arange(P) / P
    return np.abs(pts[:, None] - cum[None, :]).min(1) <= margin


def _object_and_scene(seed=0):
    """An L-shaped object of two boxes near the origin, and the scene: the
    object moved by a small motion, beside a floor patch."""
    rng = np.random.default_rng(seed)
    a = rng.uniform([-0.1, -0.15, -0.05], [0.1, 0.15, 0.05], (150, 3))
    b = rng.uniform([0.1, 0.05, -0.05], [0.25, 0.15, 0.05], (90, 3))
    obj = np.concatenate([a, b]).astype(np.float32)
    T = jpf.se3_exp(jnp.asarray([0.01, -0.006, 0.004, 0.02, -0.01, 0.015], jnp.float32))
    moved = np.asarray(obj) @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]
    floor = np.stack([rng.uniform(-0.6, 0.6, 300), np.full(300, -0.3),
                      rng.uniform(-0.6, 0.6, 300)], 1)
    scene = np.concatenate([moved, floor]).astype(np.float32)
    ref_mask = np.ones(len(obj) + 16, bool)
    ref_mask[len(obj):] = False
    ref = np.concatenate([obj, np.zeros((16, 3), np.float32)])
    return ref, ref_mask, scene


def _rows_agree(got, want, w, u0, tol=1e-4):
    same = np.abs(got - want).max(1) <= tol
    near = near_edges(w, u0, 1e-4)
    assert near.sum() <= len(w) // 8
    assert (~same).sum() <= near.sum(), ((~same).sum(), near.sum())
    assert same[~near].all()


def test_systematic_resample_matches_jax_off_edges():
    rng = np.random.default_rng(0)
    for P in (64, 600, 1000):
        w = rng.gamma(0.3, size=P).astype(np.float32)
        w /= w.sum()
        key = jax.random.PRNGKey(P)
        want = np.asarray(jpf._systematic_resample(key, jnp.asarray(w)))
        u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / P)
        got = tpf.systematic_resample(torch.tensor(np.asarray(u0)), torch.from_numpy(w)).numpy()
        firm = ~near_edges(w, u0, 1e-6)
        assert firm.mean() > 0.95
        np.testing.assert_array_equal(got[firm], want[firm])


def test_particle_filter_steps_match_jax_on_its_draws():
    ref, ref_mask, scene = _object_and_scene()
    jref, jscene = jmake(jnp.asarray(ref), jnp.asarray(ref_mask)), jmake(jnp.asarray(scene))
    tref = make_cloud(ref, ref_mask, device="cpu")
    tscene = make_cloud(scene, device="cpu")
    P, n_ref = 96, 48
    noise = jnp.asarray([0.01, 0.01, 0.01, 0.02, 0.02, 0.02], jnp.float32)
    js = jpf.init_tracker(P, key=jax.random.PRNGKey(7))
    for _ in range(3):
        draws, _ = jax_draws(js.key, P, ref_mask, n_ref)
        ts = interop.tracker_state_from_arrays(js.particles, js.weights, js.ref_pose,
                                               device="cpu")
        jn, jpose = jpf.step_tracker(js, jref, jscene, step_noise=noise, n_ref=n_ref)
        tn, tpose = tpf.step_tracker_core(ts, tref, tscene, draws, step_noise=noise)
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-4)
        _, w, _ = tpf.weigh(ts, tref, tscene, draws, noise)
        _rows_agree(tn.particles.numpy(), np.asarray(jn.particles), w.numpy(), draws.u0)
        js = jn
    # the tracker follows the motion
    np.testing.assert_allclose(np.asarray(js.ref_pose)[:3, 3], [0.01, -0.006, 0.004],
                               atol=0.01)


def test_kld_filter_steps_match_jax_on_its_draws():
    ref, ref_mask, scene = _object_and_scene(1)
    jref, jscene = jmake(jnp.asarray(ref), jnp.asarray(ref_mask)), jmake(jnp.asarray(scene))
    tref = make_cloud(ref, ref_mask, device="cpu")
    tscene = make_cloud(scene, device="cpu")
    P, n_ref = 128, 32
    kw = dict(step_noise=jnp.asarray([0.015] * 3 + [0.095] * 3, jnp.float32), bin_size=0.1,
              epsilon=0.2, z_delta=2.326, min_particles=16)
    js = jkld.init_kld_tracker(P, init_particles=80, key=jax.random.PRNGKey(9))
    lives = []
    for _ in range(3):
        draws, _ = jax_draws(js.key, P, ref_mask, n_ref)
        ts = interop.kld_state_from_arrays(js.particles, js.active, js.ref_pose, device="cpu")
        jn, jpose = jkld.step_tracker_kld(js, jref, jscene, n_ref=n_ref, **kw)
        tn, tpose = tkld.step_tracker_kld_core(ts, tref, tscene, draws, **kw)
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-4)
        np.testing.assert_array_equal(tn.active.numpy(), np.asarray(jn.active))
        _, w, _ = tkld.weigh_kld(ts, tref, tscene, draws, kw["step_noise"])
        _rows_agree(tn.particles.numpy(), np.asarray(jn.particles), w.numpy(), draws.u0)
        lives.append(int(tn.active.sum()))
        js = jn
    assert 16 <= min(lives) and max(lives) <= P


def test_kld_required_and_bins_match_jax():
    for k in (0, 1, 2, 5, 40, 300):
        a = float(tkld._kld_required(torch.tensor(k), 0.2, 2.326))
        b = float(jkld._kld_required(jnp.asarray(k), 0.2, 2.326))
        assert a == pytest.approx(b, rel=1e-6)
    # duplicate bins: the last particle written decides (C76)
    p = np.zeros((6, 6), np.float32)
    p[3:, 0] = 0.31
    active = np.array([True, True, True, True, False, False])
    assert int(tkld.occupied_bins(torch.from_numpy(p), torch.from_numpy(active), 0.1)) == 1


def _texture(H, W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = 128 + 40 * np.sin(xx / 3.1) * np.cos(yy / 4.3) + 30 * np.sin((xx + 2 * yy) / 7.7)
    return (img + 5 * rng.normal(size=(H, W))).astype(np.float32)


def _shifted(img, dy, dx):
    """``img`` moved by a sub-pixel ``(dy, dx)`` (bilinear)."""
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    y, x = np.clip(yy - dy, 0, H - 1.001), np.clip(xx - dx, 0, W - 1.001)
    y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
    fy, fx = y - y0, x - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx).astype(np.float32)


@pytest.mark.parametrize("levels,radius,shift", [(3, 4, (1.7, -2.3)), (2, 5, (0.4, 0.6))])
def test_pyramidal_klt_matches_jax(levels, radius, shift):
    a = _texture(60, 80)
    b = _shifted(a, *shift)
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-3, 63, 120), rng.uniform(-3, 83, 120)], 1).astype(np.float32)
    jn, jok = jklt.pyramidal_klt(a, b, pts, levels=levels, window_radius=radius)
    tn, tok = tklt.pyramidal_klt(a, b, pts, levels=levels, window_radius=radius, device="cpu")
    inner = (pts[:, 0] > 12) & (pts[:, 0] < 48) & (pts[:, 1] > 12) & (pts[:, 1] < 68)
    assert inner.sum() > 30
    np.testing.assert_allclose(tn[inner], np.asarray(jn)[inner], atol=1e-3)
    np.testing.assert_array_equal(tok[inner], np.asarray(jok)[inner])
    np.testing.assert_allclose(np.median(tn[inner] - pts[inner], 0), shift, atol=0.1)


def _corner_image(seed=3):
    """An 8-bit image: bright and dark squares on a grey ramp with noise."""
    rng = np.random.default_rng(seed)
    img = np.full((64, 80), 90.0) + np.arange(80)[None, :] * 0.5
    img[10:25, 12:30] = 220
    img[35:55, 40:70] = 20
    img[20:30, 50:58] = 170
    img = img + rng.integers(-3, 4, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.float32)


@pytest.mark.parametrize("threshold,arc", [(10.0, 9), (20.0, 10)])
def test_agast_matches_jax(threshold, arc):
    img = _corner_image()
    want = np.asarray(jc2d.agast_score(jnp.asarray(img), threshold, arc))
    got = tc2d.agast_score(torch.from_numpy(img), threshold, arc).numpy()
    np.testing.assert_array_equal(got, want)
    ws, wk = (np.asarray(x) for x in jc2d._agast_jit(jnp.asarray(img), threshold, arc))
    gs, gk = (x.numpy() for x in tc2d._agast(torch.from_numpy(img), threshold, arc))
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gk, wk)
    kp = tc2d.agast_keypoints(img, threshold, arc, device="cpu")
    np.testing.assert_array_equal(kp, jc2d.agast_keypoints(img, threshold, arc))
    assert len(kp) >= 4


def test_brisk_keypoints_and_descriptor_match_jax():
    img = _corner_image(4)
    kp = tc2d.brisk_keypoints(img, 20.0, octaves=2, device="cpu")
    np.testing.assert_array_equal(kp, jc2d.brisk_keypoints(img, 20.0, octaves=2))
    assert (kp[:, 2] == 1).any()
    d = tc2d.brisk_descriptor(img, kp, device="cpu")
    assert d.shape == (len(kp), 276)
    np.testing.assert_array_equal(d, jc2d.brisk_descriptor(img, kp))


def test_trajkovic_matches_jax():
    img = _corner_image(5)
    want = np.asarray(jc2d.trajkovic_score(jnp.asarray(img)))
    got = tc2d.trajkovic_score(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * want.max())
    kp = tc2d.trajkovic_keypoints(img, 100.0, device="cpu")
    np.testing.assert_array_equal(kp, jc2d.trajkovic_keypoints(img, 100.0))
    assert len(kp) > 0
