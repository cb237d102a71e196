"""Parity of pcl_tpu_torch.registration.ndt with pcl_tpu.registration.ndt on
the CPU.

Tolerances, each measured and then fixed:

- ``build_grid``: ``valid``, ``ckey1`` and ``ckey2`` equal; ``mean`` within
  1e-5 (measured 0: the port's stable sort adds each bucket's points in their
  original order, as the JAX package's scatter does on the CPU); ``icov``
  within 5e-3 of the voxel's largest entry on clouds within 5 m of the origin
  (ROADMAP C13: both sides form ``ss - mean s^T`` in float32, whose rounding
  is ``|x|^2 * 1e-7`` against a thin voxel's variance of 1e-4, and XLA fuses
  the product into the subtraction; measured 3.6e-4 to 1.8e-3 over three seeds
  at 0.5 m voxels, 0.35 at 40 m from the origin, where only the keys, the
  means and ``valid`` are compared);
- ``_gauss_constants``: ``d1`` to 1 ulp of float32, ``d2`` to 1e-6 relative
  (its numerator is a difference of two logarithms, so one ulp in a
  logarithm becomes several in ``d2``: up to 9 measured);
- score, gradient and Hessian on the JAX package's own grid carried over by
  ``interop.ndt_grid_from_arrays``: 1e-4 of their norms;
- one Newton step, with and without backtracking: transform within 1e-5;
- a whole run: pose within 2e-3 m and rad, score within 1e-3 relative,
  ``converged`` equal. A rounding difference may flip one Armijo decision,
  after which the two runs take other iterates to the same optimum: iteration
  counts are printed, not compared.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core import transforms as jtf
from pcl_tpu.core.cloud import make_cloud as jmake

from pcl_tpu_torch import interop
from pcl_tpu_torch.core.cloud import make_cloud as tmake

jn = importlib.import_module("pcl_tpu.registration.ndt")
tn = importlib.import_module("pcl_tpu_torch.registration.ndt")

SMALL_XI = np.array([0.08, -0.05, 0.06, 0.04, -0.03, 0.05], np.float32)
TABLE = 1 << 14


def structured_cloud(rng, n=3000):
    """Two planes and a curved sheet with 0.01 noise (NDT needs structure):
    the cloud of tests/test_precision_registration.py."""
    n1 = n // 3
    a = np.stack([rng.uniform(-2, 2, n1), rng.uniform(-2, 2, n1), np.zeros(n1)], 1)
    b = np.stack([rng.uniform(-2, 2, n1), np.zeros(n1), rng.uniform(0, 2, n1)], 1)
    t = rng.uniform(-2, 2, size=(n - 2 * n1, 2))
    c = np.stack([t[:, 0], t[:, 1], 0.3 * np.sin(2 * t[:, 0]) + 1.5], 1)
    pts = np.concatenate([a, b, c]).astype(np.float32)
    return pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)


def _moved(tgt, scale=1.0):
    T = np.asarray(jtf.se3_exp(jnp.asarray(SMALL_XI * scale)))
    return ((tgt - T[:3, 3]) @ T[:3, :3]).astype(np.float32), T


def _grids(xyz, mask, res, table_size=TABLE, min_points=4):
    gj = jn.build_grid(jnp.asarray(xyz), jnp.asarray(mask), res, table_size=table_size,
                       min_points=min_points)
    gt = tn.build_grid(torch.from_numpy(xyz), torch.from_numpy(mask), res,
                       table_size=table_size, min_points=min_points)
    return gj, gt


def _carried(gj):
    return interop.ndt_grid_from_arrays(
        np.asarray(gj.resolution), gj.table_size, np.asarray(gj.mean), np.asarray(gj.icov),
        np.asarray(gj.valid), np.asarray(gj.ckey1), np.asarray(gj.ckey2), device="cpu")


@pytest.mark.parametrize("case", ["plain", "masked", "collisions", "negative_cells",
                                  "far_from_origin"])
def test_build_grid_matches_jax(rng, case):
    xyz = structured_cloud(rng)
    mask = np.ones(len(xyz), bool)
    table_size, res = TABLE, 0.5
    if case == "masked":
        mask[rng.uniform(size=len(xyz)) < 0.3] = False
        xyz[~mask] = 0.0
    elif case == "collisions":
        table_size = 64            # ~220 occupied cells in 64 buckets
    elif case == "negative_cells":
        xyz = xyz - np.float32([3.0, 3.0, 3.0])
    elif case == "far_from_origin":
        xyz = xyz - np.float32([40.0, 3.0, 7.0])
        res = 0.25
    gj, gt = _grids(xyz, mask, res, table_size)
    valid = np.asarray(gj.valid)
    assert gt.mean.shape == (table_size + 1, 3) and gt.icov.shape == (table_size + 1, 3, 3)
    assert gt.table_size == table_size and float(gt.resolution) == np.float32(res)
    np.testing.assert_array_equal(gt.valid.numpy(), valid)
    np.testing.assert_array_equal(gt.ckey1.numpy(), np.asarray(gj.ckey1))
    np.testing.assert_array_equal(gt.ckey2.numpy(), np.asarray(gj.ckey2))
    np.testing.assert_allclose(gt.mean.numpy(), np.asarray(gj.mean), atol=1e-5)
    icov_j, icov_t = np.asarray(gj.icov), gt.icov.numpy()
    scale = np.abs(icov_j).reshape(-1, 9).max(1)
    err = np.abs(icov_t - icov_j).reshape(-1, 9).max(1)
    if case != "far_from_origin":
        assert (err <= 5e-3 * scale).all(), (err[valid] / scale[valid]).max()
    assert (icov_t[~valid] == 0).all() and (gt.mean.numpy()[~valid] == 0).all()
    assert not valid[table_size]                       # the row of the masked points
    if case == "collisions":
        occupied = np.asarray(gj.ckey1) != 2 ** 31 - 1
        assert 0 < valid.sum() < occupied[:table_size].sum()
    else:
        assert valid.sum() > 100
    if case in ("negative_cells", "far_from_origin"):
        # a negative x cell sets the top bit of the 16|16 key: it wraps in int32
        assert (gt.ckey1.numpy()[valid] < 0).all() and (gt.ckey2.numpy()[valid] < 0).all()


def test_build_grid_counts_one_segment_sum(rng, monkeypatch):
    """One sorted segment sum of 13 columns per grid: on CUDA tensors that is
    one launch of kernel B2, here its plain version."""
    from pcl_tpu_torch.ops import segsum
    seen = []
    plain = segsum.segment_sum_sorted

    def spy(vals, seg):
        seen.append(tuple(vals.shape))
        assert bool((seg[1:] >= seg[:-1]).all())
        return plain(vals, seg)

    monkeypatch.setattr(segsum, "segment_sum_sorted", spy)
    xyz = structured_cloud(rng, 600)
    tn.build_grid(torch.from_numpy(xyz), torch.ones(600, dtype=torch.bool), 0.5, table_size=TABLE)
    assert seen == [(600, 13)]


@pytest.mark.parametrize("res,ratio", [(0.5, 0.55), (1.0, 0.55), (2.0, 0.55), (0.3, 0.2)])
def test_gauss_constants_to_one_ulp(res, ratio):
    want = [np.asarray(v) for v in jn._gauss_constants(res, ratio)]
    got = tn._gauss_constants(res, ratio)
    for g in got:
        assert g.dtype == torch.float32 and g.device.type == "cpu"
    assert abs(float(got[0]) - float(want[0])) <= np.spacing(np.abs(want[0]))
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-6)


def _ops(gj, n_off, sm, res):
    offsets = {1: jn._OFFSETS27[:1], 7: jn._OFFSETS7, 27: jn._OFFSETS27}[n_off]
    d1, d2 = jn._gauss_constants(res)
    j_ops = jn.make_score_ops(gj, offsets, jnp.asarray(res, jnp.float32), d1, d2,
                              jnp.asarray(sm))
    t_ops = tn.make_score_ops(_carried(gj), torch.from_numpy(np.array(offsets)),
                              torch.tensor(np.float32(res)), *tn._gauss_constants(res),
                              torch.from_numpy(sm))
    return j_ops, t_ops


def _newton_direction_jax(g, H, step_size):
    """The step of pcl_tpu's newton_step, from its own g and H."""
    lam = 1e-3 * jnp.maximum(jnp.trace(H) / 6.0, 1e-6)
    delta = -jnp.linalg.solve(H + jnp.abs(lam) * jnp.eye(6), g)
    delta = jnp.where(jnp.dot(delta, g) < 0.0, delta, -g)
    dn = jnp.linalg.norm(delta)
    return delta * jnp.minimum(1.0, step_size / jnp.maximum(dn, 1e-12))


@pytest.mark.parametrize("n_off", [1, 7, 27])
def test_score_gradient_hessian_on_the_jax_grid(rng, n_off):
    res = 0.5
    tgt = structured_cloud(rng)
    src, _ = _moved(tgt)
    sm = np.ones(len(src), bool)
    sm[::11] = False
    gj, _ = _grids(tgt, np.ones(len(tgt), bool), res)
    (jgather, jscore, jgh), (tgather, tscore, tgh) = _ops(gj, n_off, sm, res)
    for pose in (np.eye(4, dtype=np.float32),
                 np.asarray(jtf.se3_exp(jnp.asarray(0.6 * SMALL_XI)))):
        p = (src @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
        pj, pt = jnp.asarray(p), torch.from_numpy(p)
        fj, gj_, Hj = jgh(pj, jgather(pj))
        rows = tgather(pt)
        ft, gt_, Ht = tgh(pt, rows)
        assert rows.ok.shape == (len(p) * n_off,) and int(rows.ok.sum()) > 500
        assert float(ft) == pytest.approx(float(fj), rel=1e-4)
        assert float(tscore(rows, pt)) == pytest.approx(float(jscore(jgather(pj), pj)), rel=1e-4)
        assert float(tscore(rows, pt)) == pytest.approx(float(ft), rel=1e-5)
        assert np.linalg.norm(gt_.numpy() - np.asarray(gj_)) <= 1e-4 * np.linalg.norm(gj_)
        assert np.linalg.norm(Ht.numpy() - np.asarray(Hj)) <= 1e-4 * np.linalg.norm(Hj)
        np.testing.assert_allclose(Ht.numpy(), Ht.numpy().T, atol=1e-4 * float(Ht.abs().max()))
        for step_size in (0.1, 10.0):
            want = np.asarray(_newton_direction_jax(gj_, Hj, step_size))
            got = tn._newton_direction(gt_, Ht, step_size).numpy()
            # the 6x6 solve amplifies the 1e-4 of g and H by H's conditioning
            assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want)
            assert np.linalg.norm(got) <= step_size * (1 + 1e-6)


def test_newton_direction_falls_back_to_the_gradient():
    H = -torch.eye(6)                       # concave: the Newton step ascends
    g = torch.tensor([1.0, 0, 0, 0, 0, 0])
    d = tn._newton_direction(g, H, step_size=0.1)
    np.testing.assert_allclose(d.numpy(), [-0.1, 0, 0, 0, 0, 0], atol=1e-7)


def _count_exp(monkeypatch):
    calls = []
    orig = tn.se3_exp
    monkeypatch.setattr(tn, "se3_exp", lambda xi: calls.append(1) or orig(xi))
    return calls


@pytest.mark.parametrize("step_size,backtracks", [(0.1, False), (0.5, True)])
def test_one_newton_step_matches_jax(rng, monkeypatch, step_size, backtracks):
    """The tight test is one step: with step_size 0.5 the full step fails the
    Armijo test and the halvings are tried (one trial pose, seven halvings and
    the accepted pose: nine exponentials against one)."""
    tgt = structured_cloud(rng)
    src, _ = _moved(tgt)
    kw = dict(resolution=0.5, max_iterations=1, table_size=TABLE, min_points=4,
              step_size=step_size)
    want = jn.ndt(jmake(jnp.asarray(src)), jmake(jnp.asarray(tgt)), **kw)
    calls = _count_exp(monkeypatch)
    got = tn.ndt(tmake(src, device="cpu"), tmake(tgt, device="cpu"), **kw)
    assert len(calls) == (9 if backtracks else 1)
    assert int(got.iterations) == int(want.iterations) == 1
    assert got.iterations.dtype == torch.int32 and got.transform.dtype == torch.float32
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-5)
    assert float(got.score) == pytest.approx(float(want.score), rel=1e-4)
    assert bool(got.converged) == bool(want.converged) is False
    assert np.abs(got.transform.numpy() - np.eye(4)).max() > 1e-3       # it moved


@pytest.mark.parametrize("case", ["default", "neighborhood_1", "neighborhood_27",
                                  "far_start", "long_steps", "init_transform"])
def test_ndt_matches_jax(rng, case):
    tgt = structured_cloud(rng)
    src, T_true = _moved(tgt, 3.0 if case == "far_start" else 1.0)
    kw = dict(resolution=0.5, max_iterations=40, table_size=TABLE, min_points=4)
    init_j = init_t = None
    if case.startswith("neighborhood"):
        kw["neighborhood"] = int(case.split("_")[1])
    elif case == "long_steps":
        kw["step_size"] = 0.5
    elif case == "init_transform":
        init = np.asarray(jtf.se3_exp(jnp.asarray(0.5 * SMALL_XI)))
        init_j, init_t = jnp.asarray(init), torch.from_numpy(init.copy())
    want = jn.ndt(jmake(jnp.asarray(src)), jmake(jnp.asarray(tgt)), init_transform=init_j, **kw)
    got = tn.ndt(tmake(src, device="cpu"), tmake(tgt, device="cpu"), init_transform=init_t, **kw)
    print(f"{case}: iterations jax {int(want.iterations)} port {int(got.iterations)}, score "
          f"{float(want.score):.6f} {float(got.score):.6f}")
    Tw, Tg = np.asarray(want.transform), got.transform.numpy()
    assert np.linalg.norm(Tg[:3, 3] - Tw[:3, 3]) <= 2e-3
    rel = Tg[:3, :3] @ Tw[:3, :3].T
    assert np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)) <= 2e-3
    assert float(got.score) == pytest.approx(float(want.score), rel=1e-3)
    assert bool(got.converged) == bool(want.converged) is True
    # NDT's voxel-attraction bias; one voxel per point sees less of the surface
    assert np.linalg.norm(Tg[:3, 3] - T_true[:3, 3]) < (0.2 if case == "neighborhood_1" else 0.15)


def test_ndt_without_iterations_or_overlap(rng):
    tgt = structured_cloud(rng, 900)
    src = tmake(tgt + np.float32(500.0), device="cpu")           # no voxel in reach
    res = tn.ndt(src, tmake(tgt, device="cpu"), resolution=0.5, table_size=TABLE)
    want = jn.ndt(jmake(jnp.asarray(tgt + np.float32(500.0))), jmake(jnp.asarray(tgt)),
                  resolution=0.5, table_size=TABLE)
    assert int(res.iterations) == int(want.iterations)
    assert bool(res.converged) == bool(want.converged)
    np.testing.assert_array_equal(res.transform.numpy(), np.eye(4, dtype=np.float32))
    none = tn.ndt(src, tmake(tgt, device="cpu"), resolution=0.5, table_size=TABLE,
                  max_iterations=0)
    assert int(none.iterations) == 0 and not bool(none.converged)


def test_ndt_grid_from_arrays_checks_shapes():
    with pytest.raises(ValueError, match="does not match"):
        interop.ndt_grid_from_arrays(1.0, 8, np.zeros((5, 3)), np.zeros((9, 3, 3)),
                                     np.zeros(9, bool), np.zeros(9), np.zeros(9), device="cpu")
