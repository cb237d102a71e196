"""Parity of pcl_tpu_torch.registration.ndt2d with the JAX package on the
CPU.

- ``_hash2`` and ``_pack2``: bit for bit, for negative, large and extreme
  int32 cell coordinates (uint32 arithmetic emulated in int64);
- ``_eigh22`` to 1e-6 relative;
- ``build_grid_2d``: owner keys, ``valid`` and means exact; inverse
  covariances to 1e-4 of the largest entry (the covariance's cancelling
  subtraction takes its product fused, as XLA's CPU code does: ROADMAP C13);
- the Newton solver on the JAX package's own grid, for a few iterations:
  parameters to 1e-5 and the score to 1e-5 relative (closed-form derivatives
  against ``jax.grad``/``jax.hessian``, which agree to float32 rounding);
- ``ndt_2d`` end to end on tests/test_ndt2d.py's scans: convergence alike,
  parameters to 5e-3 (m, rad). The Armijo and stop tests are float32
  decisions on a score summed in another order: at the coarsest level (3.2 m
  cells on a 4 m room) Newton zigzags for its 30 iterations and the two
  packages part there (seed 42: 0.145 against 0.072 m of a 0.15 m step), then
  stop on the flat optimum 2e-3 apart; with seed 0 they agree bitwise.
  Iteration counts are not compared."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.registration import ndt2d as jn

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.registration import ndt2d as tn


def _scan(rng, n=1500):
    """Two walls of a room, z = 0 (tests/test_ndt2d.py)."""
    t = rng.uniform(0, 4, n // 2).astype(np.float32)
    pts = np.concatenate([np.stack([t, np.zeros_like(t)], 1), np.stack([np.zeros_like(t), t], 1)])
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    return np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)


def _pair(theta=0.08, t=(0.15, -0.1), seed=42):
    tgt = _scan(np.random.default_rng(seed))
    c, s = np.cos(theta), np.sin(theta)
    src = tgt.copy()
    src[:, :2] = (tgt[:, :2] - np.float32(t)) @ np.array([[c, -s], [s, c]], np.float32)
    return src, tgt


def _coords():
    rng = np.random.default_rng(0)
    cc = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(2000, 2), dtype=np.int64)
    edge = np.array([[-2 ** 31, 2 ** 31 - 1], [-1, -1], [0, 0], [32767, -32768],
                     [65535, 65536], [-70000, 123456]])
    small = rng.integers(-300, 300, size=(500, 2))
    return np.concatenate([cc, edge, small]).astype(np.int32)


@pytest.mark.parametrize("table_size", [1 << 16, 1000])
def test_hash2_bit_exact(table_size):
    cc = _coords()
    want = np.asarray(jn._hash2(jnp.asarray(cc), table_size))
    np.testing.assert_array_equal(tn._hash2(torch.from_numpy(cc), table_size).numpy(), want)


def test_pack2_bit_exact():
    cc = _coords()
    np.testing.assert_array_equal(tn._pack2(torch.from_numpy(cc)).numpy(),
                                  np.asarray(jn._pack2(jnp.asarray(cc))))


def test_eigh22():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(300, 2, 2)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1)
    M[:5] = 0.0                                          # degenerate
    M[5:10] = np.eye(2, dtype=np.float32)
    lj, Vj = (np.asarray(x) for x in jn._eigh22(jnp.asarray(M)))
    lt, Vt = (x.numpy() for x in tn._eigh22(torch.from_numpy(M)))
    scale = np.abs(M).max(axis=(1, 2))[:, None] + 1e-12
    np.testing.assert_allclose(lt / scale, lj / scale, atol=1e-6)
    np.testing.assert_allclose(Vt, Vj, atol=1e-5)


@pytest.mark.parametrize("cell", [0.8, 1.6])
def test_build_grid_2d(cell):
    _, tgt = _pair()
    m = np.ones(len(tgt), bool)
    m[::11] = False
    gj = jn.build_grid_2d(jnp.asarray(tgt[:, :2]), jnp.asarray(m), cell)
    gt = tn.build_grid_2d(torch.from_numpy(tgt[:, :2]), torch.from_numpy(m), cell)
    for f in ("valid", "ckey", "mean", "shifts"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)), err_msg=f)
    ij = np.asarray(gj.icov)
    scale = np.abs(ij).max(axis=(2, 3), keepdims=True) + 1e-12
    np.testing.assert_allclose(gt.icov.numpy() / scale, ij / scale, atol=1e-4)
    assert int(gt.valid.sum()) > 20


@pytest.mark.parametrize("iters", [3])
def test_solver_on_the_jax_grid(iters):
    src, tgt = _pair()
    cell = 1.6
    # from a start past the coarsest level's zigzag, both runs step alike
    m = jnp.ones(len(src), bool)
    gj = jn.build_grid_2d(jnp.asarray(tgt[:, :2]), m, cell)
    p0 = np.float32([0.03, 0.02, 0.045])
    pj, itj, fj, cj = jn._ndt2d_solve(gj, jnp.float32(cell), jnp.asarray(src[:, :2]), m,
                                      jnp.asarray(p0), iters, 1e-5, 0.5, 1 << 16)
    grid = tn.NDT2DGrid(*(torch.from_numpy(np.array(getattr(gj, f))) for f in gj._fields))
    pt, itt, ft, ct = tn._ndt2d_solve(grid, torch.tensor(cell), torch.from_numpy(src[:, :2]),
                                      torch.from_numpy(np.asarray(m)), torch.from_numpy(p0),
                                      iters, 1e-5, 0.5, 1 << 16)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    assert float(ft) == pytest.approx(float(fj), rel=1e-5)
    assert itt == int(itj) and bool(ct) == bool(cj)


def test_score_derivatives_match_autodiff():
    src, tgt = _pair()
    cell = 0.8
    m = jnp.ones(len(src), bool)
    gj = jn.build_grid_2d(jnp.asarray(tgt[:, :2]), m, cell)
    grid = tn.NDT2DGrid(*(torch.from_numpy(np.array(getattr(gj, f))) for f in gj._fields))
    xs = jnp.asarray(src[:, :2])

    def score(p):                       # the JAX package's score_fn, verbatim
        c, s = jnp.cos(p[2]), jnp.sin(p[2])
        q = xs @ jnp.array([[c, -s], [s, c]]).T + p[:2][None, :]
        tot = 0.0
        for g in range(4):
            cc = jnp.floor(q / jnp.float32(cell) + gj.shifts[g][None, :]).astype(jnp.int32)
            h = jn._hash2(cc, 1 << 16)
            ok = gj.valid[g][h] & (gj.ckey[g][h] == jn._pack2(cc))
            x = q - gj.mean[g][h]
            md = jnp.einsum("ni,nij,nj->n", x, gj.icov[g][h], x)
            tot = tot + jnp.sum(jnp.where(ok, jnp.exp(-0.5 * jnp.minimum(md, 50.0)), 0.0))
        return -tot

    for p in ([0.1, -0.05, 0.03], [0.15, -0.1, 0.08]):
        pj = jnp.asarray(p, jnp.float32)
        f, g, H = tn._score(grid, torch.tensor(cell), torch.from_numpy(src[:, :2]),
                            torch.ones(len(src), dtype=torch.bool), torch.tensor(p), 1 << 16,
                            True)
        assert float(f) == pytest.approx(float(score(pj)), rel=1e-5)
        # a sum of ~3000 terms of both signs: 1e-3 of its largest component
        gs = np.abs(np.asarray(jax.grad(score)(pj))).max()
        np.testing.assert_allclose(g.numpy() / gs, np.asarray(jax.grad(score)(pj)) / gs, atol=1e-3)
        Hj = np.asarray(jax.hessian(score)(pj))
        np.testing.assert_allclose(H.numpy() / np.abs(Hj).max(), Hj / np.abs(Hj).max(), atol=1e-5)


@pytest.mark.parametrize("case,seed", [("offset", 0), ("identity", 42)])
def test_ndt_2d_matches_jax(case, seed):
    src, tgt = _pair(seed=seed) if case == "offset" else (_pair(seed=seed)[1],) * 2
    kw = dict(grid_extent=0.8, max_iterations=30)      # one JAX compilation for both
    jr = jn.ndt_2d(JCloud(xyz=jnp.asarray(src), mask=jnp.ones(len(src), bool)),
                   JCloud(xyz=jnp.asarray(tgt), mask=jnp.ones(len(tgt), bool)), **kw)
    tr = tn.ndt_2d(make_cloud(src, device="cpu"), make_cloud(tgt, device="cpu"), **kw)
    np.testing.assert_allclose(tr.params.numpy(), np.asarray(jr.params), atol=5e-3)
    np.testing.assert_allclose(tr.transform.numpy(), np.asarray(jr.transform), atol=5e-3)
    assert bool(tr.converged) == bool(jr.converged) is True
    assert float(tr.score) == pytest.approx(float(jr.score), rel=1e-2)
    if case == "offset":
        np.testing.assert_allclose(tr.params.numpy(), [0.15, -0.1, 0.08], atol=0.02)
