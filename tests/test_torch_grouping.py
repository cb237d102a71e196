"""Parity of the port's correspondence grouping and hypothesis verification
with the JAX package on the CPU.

Tolerances:
- Instances and members equal; transforms to 1e-5 (Umeyama in two
  libraries). Geometric consistency forms its pair distances as XLA's CPU
  code does (ROADMAP C75), so ``|dm - ds| < gc_size`` decides alike.
- Hough 3-D: the scenes keep every vote more than 1e-4 of a bin from an
  edge and from a bin's middle (``frac >= 0.5``). The float-to-int cast is
  XLA's at NaN and +-3e9 (C71); the int32 hash wraps, and a cell whose hash
  is INT_MIN takes the same bucket (0).
- SAC refinement runs its core on the JAX package's own draws (C17).
- Verification: every 1-NN distance of the scenes lies more than 8 ulp of
  ``|q|^2 + |t|^2`` from each threshold (C1); greedy verification's marks
  keep the last of duplicate scene indices, as XLA does (C76), and a scene
  where first-wins would decide otherwise shows it. Global verification's
  scenes have one clear best flip a move.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core import transforms as jtf
from pcl_tpu.recognition import grouping as jgr
from pcl_tpu.recognition import verification as jver
jransac = importlib.import_module("pcl_tpu.sac.ransac")

from pcl_tpu_torch.recognition import grouping as tgr
from pcl_tpu_torch.recognition import verification as tver

ULP = 2.0 ** -23


def _t(x):
    return torch.from_numpy(np.array(x))


def _a(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_result(t, j, tol=1e-5):
    np.testing.assert_array_equal(_a(t.instances), np.asarray(j.instances))
    np.testing.assert_array_equal(_a(t.members), np.asarray(j.members))
    np.testing.assert_allclose(_a(t.transforms), np.asarray(j.transforms), atol=tol)


def _pose(xi):
    return np.asarray(jtf.se3_exp(jnp.asarray(xi, jnp.float32)))


def _instances_scene(seed, n_true=(20, 14), n_noise=15):
    """Two moved copies of a model's keypoints and noise correspondences."""
    rng = np.random.default_rng(seed)
    mp, sp = [], []
    for i, n in enumerate(n_true):
        m = rng.normal(size=(n, 3)).astype(np.float32)
        T = _pose([0.3 + i, -0.2, 0.5, 0.2, 0.1 * i, -0.3])
        mp.append(m)
        sp.append((m @ T[:3, :3].T + T[:3, 3]).astype(np.float32))
    mp.append(rng.normal(size=(n_noise, 3)).astype(np.float32))
    sp.append(rng.normal(size=(n_noise, 3)).astype(np.float32) + 5.0)
    return np.concatenate(mp), np.concatenate(sp)


@pytest.mark.parametrize("gc_size,min_size", [(0.01, 5), (0.3, 3)])
def test_geometric_consistency_matches_jax(gc_size, min_size):
    mp, sp = _instances_scene(1)
    valid = np.ones(len(mp), bool)
    valid[3] = False
    j = jgr.geometric_consistency_grouping(jnp.asarray(mp), jnp.asarray(sp), jnp.asarray(valid),
                                           gc_size=gc_size, min_cluster_size=min_size,
                                           max_instances=3)
    t = tgr.geometric_consistency_grouping(_t(mp), _t(sp), _t(valid), gc_size=gc_size,
                                           min_cluster_size=min_size, max_instances=3)
    _same_result(t, j)
    assert bool(t.instances[0])


def _frames(rng, n):
    return np.stack([_pose(np.r_[0, 0, 0, rng.normal(size=3)])[:3, :3] for _ in range(n)]
                    ).astype(np.float32)


def _votes64(mp, sp, centroid, mrf=None, srf=None):
    off = centroid[None].astype(np.float64) - mp
    if mrf is None:
        return sp + off
    return sp + np.einsum("cji,cj->ci", srf, np.einsum("cij,cj->ci", mrf, off))


def _firm_votes(votes, bin_size, eps=1e-4):
    g = votes / bin_size
    frac = g - np.floor(g)
    return (np.abs(frac) > eps).all() and (np.abs(1 - frac) > eps).all() \
        and (np.abs(frac - 0.5) > eps).all()


@pytest.mark.parametrize("frames,interp,dweight", [(False, True, False), (True, True, False),
                                                   (True, False, False), (False, True, True)],
                         ids=["translation", "frames", "frames-nointerp", "distance-weight"])
def test_hough3d_matches_jax(frames, interp, dweight):
    rng = np.random.default_rng(5)
    model = rng.normal(size=(30, 3)).astype(np.float32)
    T = _pose([1.0, -0.5, 2.0, 0.4, -0.2, 0.3] if frames else [1.0, -0.5, 2.0, 0, 0, 0])
    scene = (model @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    mp = np.concatenate([model, rng.normal(size=(12, 3)).astype(np.float32)])
    sp = np.concatenate([scene, rng.uniform(-4, 4, (12, 3)).astype(np.float32)])
    valid = np.ones(len(mp), bool)
    valid[-1] = False
    centroid = model.mean(0)
    kw = dict(bin_size=0.1, threshold=5.0, max_instances=3, use_interpolation=interp,
              use_distance_weight=dweight)
    if frames:
        # model frames and the scene frames the motion gives them
        mrf = _frames(rng, len(mp))
        srf = np.einsum("cij,kj->cik", mrf, T[:3, :3]).astype(np.float32)
        srf[len(model):] = _frames(rng, len(mp) - len(model))
        kw_j = dict(kw, model_rf=jnp.asarray(mrf), scene_rf=jnp.asarray(srf))
        kw_t = dict(kw, model_rf=_t(mrf), scene_rf=_t(srf))
        assert _firm_votes(_votes64(mp, sp, centroid, mrf, srf), 0.1)
    else:
        kw_j, kw_t = dict(kw), dict(kw)
        assert _firm_votes(_votes64(mp, sp, centroid), 0.1)
    if dweight:
        cd = rng.uniform(0.1, 1.0, len(mp)).astype(np.float32)
        kw_j["corr_distance"], kw_t["corr_distance"] = jnp.asarray(cd), _t(cd)
    j = jgr.hough3d_grouping(jnp.asarray(mp), jnp.asarray(sp), jnp.asarray(valid),
                             jnp.asarray(centroid), **kw_j)
    t = tgr.hough3d_grouping(_t(mp), _t(sp), _t(valid), _t(centroid), **kw_t)
    _same_result(t, j, tol=2e-5)
    assert bool(t.instances[0]) and _a(t.members[0])[:30].mean() > 0.9


@pytest.mark.parametrize("interp", [False, True])
def test_hough3d_casts_nan_and_3e9_as_xla(interp):
    """Votes at NaN, +-3e9 bins: XLA's cast takes NaN to 0 and saturates
    (C71), and the port's cast is the same. The groups are placed so that
    torch's plain cast would bucket them otherwise: four votes with a NaN
    coordinate share the cell of four finite ones only through the NaN-to-0
    cast, and votes at +3e9 and -3e9 bins share a cell only where both cast
    to INT_MIN."""
    rng = np.random.default_rng(9)
    model = rng.normal(size=(12, 3)).astype(np.float32)
    scene = model + np.float32([0.52, -0.31, 0.27])
    groups = [[np.nan, 0.15, 0.15], [0.03, 0.15, 0.15], [3e9 * 0.1, 0.15, 0.15],
              [-3e9 * 0.1, 0.15, 0.15]]
    extra_s = np.repeat(np.array(groups, np.float32), 4, axis=0)
    mp = np.concatenate([model, np.zeros((len(extra_s), 3), np.float32)])
    sp = np.concatenate([scene, extra_s])
    valid = np.ones(len(mp), bool)
    centroid = np.zeros(3, np.float32)
    kw = dict(bin_size=0.1, threshold=3.0, max_instances=4, use_interpolation=interp)
    j = jgr.hough3d_grouping(jnp.asarray(mp), jnp.asarray(sp), jnp.asarray(valid),
                             jnp.asarray(centroid), **kw)
    t = tgr.hough3d_grouping(_t(mp), _t(sp), _t(valid), _t(centroid), **kw)
    np.testing.assert_array_equal(_a(t.instances), np.asarray(j.instances))
    np.testing.assert_array_equal(_a(t.members), np.asarray(j.members))
    np.testing.assert_allclose(_a(t.transforms), np.asarray(j.transforms), atol=1e-5,
                               equal_nan=True)
    if not interp:
        sizes = _a(t.members).sum(1).tolist()
        assert sizes == [12, 8, 4, 4], sizes


def test_hough_hash_of_int_min_takes_bucket_zero():
    """``abs(INT_MIN)`` stays negative in both packages; the floor modulo
    still gives a non-negative bucket, the same in both."""
    cells = np.array([[-(2 ** 31), 0, 0], [2 ** 31 - 1, 5, -7], [12345, -99999, 31],
                      [-1, -1, -1]], np.int32)

    def jax_hash(c, size):
        h = ((c[..., 0] * 73856093) ^ (c[..., 1] * 19349669) ^ (c[..., 2] * 83492791))
        return jnp.abs(h) % jnp.int32(size)

    for size in (1 << 16, 1000):
        a = _a(tgr._cell_hash(_t(cells), size))
        b = np.asarray(jax_hash(jnp.asarray(cells), size))
        np.testing.assert_array_equal(a, b)
        assert a[0] == (0 if size == 1 << 16 else b[0]) and (a >= 0).all()


def _jax_grouping_draws(result, n_hyp, key=None):
    """The draws of the JAX package's ``refine_grouping_sac`` (fold_in per
    instance, then RANSAC's split and categorical)."""
    key = jax.random.PRNGKey(7) if key is None else key
    out = []
    for i in range(int(result.instances.shape[0])):
        if not bool(result.instances[i]):
            out.append(None)
            continue
        k_idx, _ = jax.random.split(jax.random.fold_in(key, i))
        w = result.members[i].astype(jnp.float32)
        probs = w / jnp.maximum(jnp.sum(w), 1.0)
        idx = jransac._sample_indices(k_idx, n_hyp, 3, w.shape[0], probs)
        out.append(torch.from_numpy(np.asarray(idx)))
    return out


def test_refine_grouping_sac_matches_jax_on_its_draws():
    mp, sp = _instances_scene(3)
    sp = sp + np.random.default_rng(4).normal(scale=0.01, size=sp.shape).astype(np.float32)
    valid = np.ones(len(mp), bool)
    kw = dict(gc_size=0.1, min_cluster_size=4, max_instances=3)
    jres = jgr.geometric_consistency_grouping(jnp.asarray(mp), jnp.asarray(sp),
                                              jnp.asarray(valid), **kw)
    tres = tgr.geometric_consistency_grouping(_t(mp), _t(sp), _t(valid), **kw)
    _same_result(tres, jres)
    j = jgr.refine_grouping_sac(mp, sp, jres, 0.02, n_hypotheses=256)
    t = tgr.refine_grouping_sac_core(_t(mp), _t(sp), tres, 0.02, _jax_grouping_draws(jres, 256))
    _same_result(t, j)
    # the sampler draws members of each instance
    drawn = tgr.draw_grouping_samples(tres, 64, torch.Generator().manual_seed(0))
    for i, idx in enumerate(drawn):
        if idx is not None:
            assert _a(tres.members[i])[_a(idx)].all()


def test_last_writer_is_xla_last_wins():
    """``.at[pt].set(v)`` with duplicate indices keeps the last write on
    XLA's CPU; ``last_writer`` picks that write without any order."""
    rng = np.random.default_rng(0)
    pt = rng.integers(0, 300, 2000)
    v = rng.random(2000) < 0.5
    b = np.asarray(jnp.zeros(300, bool).at[jnp.asarray(pt)].set(jnp.asarray(v)))
    last = _a(tver.last_writer(_t(pt), 300))
    a = np.where(last >= 0, v[np.maximum(last, 0)], False)
    np.testing.assert_array_equal(a, b)
    want = np.zeros(300, bool)
    for i, s in enumerate(pt):
        want[s] = v[i]
    np.testing.assert_array_equal(b, want)
    assert np.asarray(jnp.zeros(4, bool).at[jnp.asarray([1, 1, 2, 2])].set(
        jnp.asarray([True, False, False, True]))).tolist() == [False, False, True, False]


def _margins_ok(q, t, tmask, thresholds):
    """Every query's float64 1-NN distance more than 8 ulp of ``|q|^2 +
    |t|^2`` from each threshold (ROADMAP C1)."""
    q = q.astype(np.float64)
    t = t[tmask].astype(np.float64)
    d2 = ((q[:, None, :] - t[None]) ** 2).sum(-1)
    j = d2.argmin(1)
    best = d2[np.arange(len(q)), j]
    scale = (q ** 2).sum(1) + (t[j] ** 2).sum(1)
    return all((np.abs(best - thr ** 2) > 8 * ULP * scale).all() for thr in thresholds)


def _moved(model, Ts):
    return np.concatenate([model @ T[:3, :3].T + T[:3, 3] for T in Ts])


def _duplicates_scene():
    """Scene points on a 1 m grid; the model has two points at each, 5 mm
    and 10 cm off, so both map to one scene point and the later one is not
    explained. Hypothesis 1 is hypothesis 0 moved 3 mm: equal support, so it
    comes second; it is accepted only if hypothesis 0 left its scene points
    unmarked, as last-wins does."""
    g = np.stack(np.meshgrid(np.arange(5.0), np.arange(4.0), [0.0], indexing="ij"), -1)
    scene = g.reshape(-1, 3).astype(np.float32)
    model = np.repeat(scene, 2, axis=0)
    model[0::2, 0] += 0.005
    model[1::2, 1] += 0.1
    T0 = np.eye(4, dtype=np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T1[0, 3] = 0.003
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [20.0, 0.0, 0.0]
    return model.astype(np.float32), np.stack([T0, T1, T2]), scene


def _verify_both(name, model, Ts, ok, scene, smask, **kw):
    j = getattr(jver, name)(jnp.asarray(model), jnp.asarray(Ts), jnp.asarray(ok),
                            jnp.asarray(scene), jnp.asarray(smask), **kw)
    t = getattr(tver, name)(_t(model), _t(Ts), _t(ok), _t(scene), _t(smask), **kw)
    return _a(t), np.asarray(j)


def test_greedy_verification_keeps_the_last_duplicate_mark():
    model, Ts, scene = _duplicates_scene()
    smask = np.ones(len(scene), bool)
    assert _margins_ok(_moved(model, Ts), scene, smask, [0.02])
    a, b = _verify_both("greedy_hypothesis_verification", model, Ts, np.ones(3, bool), scene,
                        smask, inlier_threshold=0.02)
    np.testing.assert_array_equal(a, b)
    assert a.tolist() == [True, True, False]


def _two_instance_scene(seed):
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.1, 0.1, size=(80, 3)).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T1[:3, 3] = [0.5, 0, 0]
    T2 = _pose([-0.5, 0.2, 0.0, 0.3, 0.0, 0.2]).astype(np.float32)
    scene = _moved(model, [T1, T2]).astype(np.float32)
    scene += rng.normal(scale=0.002, size=scene.shape).astype(np.float32)
    T1b = T1.copy()
    T1b[:3, 3] += [0.004, 0, 0]
    T3 = np.eye(4, dtype=np.float32)
    T3[:3, 3] = [3.0, 3.0, 0]
    T4 = T2.copy()
    T4[:3, 3] += [0.0, 0.15, 0.0]
    return model, np.stack([T1, T2, T1b, T3, T4]).astype(np.float32), scene


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kw", [
    ("greedy_hypothesis_verification", dict(inlier_threshold=0.02)),
    ("global_hypothesis_verification", dict(inlier_threshold=0.02)),
    ("papazov_hypothesis_verification", dict(inlier_threshold=0.02)),
    ("papazov_hypothesis_verification", dict(inlier_threshold=0.01, support_threshold=0.5,
                                             penalty_threshold=0.3)),
], ids=["greedy", "global", "papazov", "papazov-tight"])
def test_verifiers_match_jax(name, kw, seed):
    model, Ts, scene = _two_instance_scene(seed)
    smask = np.ones(len(scene), bool)
    smask[::17] = False
    ok = np.array([True, True, True, True, False])
    thr = kw["inlier_threshold"]
    assert _margins_ok(_moved(model, Ts), scene, smask, [thr, 2 * thr])
    a, b = _verify_both(name, model, Ts, ok, scene, smask, **kw)
    np.testing.assert_array_equal(a, b)
    assert a[0] and a[1] and not a[3] and not a[4]
