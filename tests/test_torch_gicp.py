"""Parity of pcl_tpu_torch.registration.gicp (and the 6-D branch of
search.bruteforce.nn1) with the JAX package on the CPU.

Covariances: ``C = V diag(eps, 1, 1) V^T = I - (1 - eps) v0 v0^T`` depends only
on the smallest eigenvector, which is defined where its eigenvalue is
isolated; and a neighbourhood is defined where the k-th and (k+1)-th
neighbours do not tie (ROADMAP C8, C9, C12). The comparison holds the "firm"
points to 2e-5 and counts the others. Whole runs: poses within 1e-3
(measured ~1e-8), ``truncated`` and ``converged`` equal,
iteration counts printed and held to +-1 (the brute 1-NN returns exact
distances in the port and the matmul identity in the JAX package on the CPU,
ROADMAP C1, which can move a near-tie).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core import transforms as jtf
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.features.shot import _rgb_to_lab as j_rgb_to_lab
from pcl_tpu.ops import batch33 as jb
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch.core.cloud import Cloud as TCloud
from pcl_tpu_torch.core.cloud import make_cloud as tmake
from pcl_tpu_torch.features.shot import _rgb_to_lab as t_rgb_to_lab
from pcl_tpu_torch.search import bruteforce as tbf

jg = importlib.import_module("pcl_tpu.registration.gicp")
tg = importlib.import_module("pcl_tpu_torch.registration.gicp")

SMALL_XI = np.array([0.08, -0.05, 0.06, 0.04, -0.03, 0.05], np.float32)


def structured_cloud(rng, n=1500):
    """Two planes and a curved sheet with 0.01 noise: the surface-like cloud
    of tests/test_precision_registration.py."""
    n1 = n // 3
    a = np.stack([rng.uniform(-2, 2, n1), rng.uniform(-2, 2, n1), np.zeros(n1)], 1)
    b = np.stack([rng.uniform(-2, 2, n1), np.zeros(n1), rng.uniform(0, 2, n1)], 1)
    t = rng.uniform(-2, 2, size=(n - 2 * n1, 2))
    c = np.stack([t[:, 0], t[:, 1], 0.3 * np.sin(2 * t[:, 0]) + 1.5], 1)
    pts = np.concatenate([a, b, c]).astype(np.float32)
    return pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)


def _pair(rng, n=1500, resample=False):
    tgt = structured_cloud(rng, n)
    T_true = np.asarray(jtf.se3_exp(jnp.asarray(SMALL_XI)))
    base = structured_cloud(rng, n) if resample else tgt
    src = ((base - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32)
    return src, tgt, T_true


@pytest.mark.parametrize("dim,chunk,tile", [(6, 2048, 8192), (6, 64, 100), (2, 50, 33)])
def test_nn1_other_widths_match_jax(rng, dim, chunk, tile):
    """F1: a search that is not 3-D takes the chunked matmul-identity sweep in
    both packages (masked targets, exact ties: the lowest index wins)."""
    t = rng.normal(size=(700, dim)).astype(np.float32)
    t[300:350] = t[100:150]                                  # exact ties
    q = np.concatenate([rng.normal(size=(257, dim)).astype(np.float32), t[120:140]])
    tm = rng.uniform(size=700) > 0.2
    tm[100:150] = tm[300:350] = True
    wi, wd = jbf.nn1(jnp.asarray(t), jnp.asarray(tm), jnp.asarray(q))
    gi, gd = tbf.nn1(torch.from_numpy(t), torch.from_numpy(tm), torch.from_numpy(q),
                     chunk=chunk, tile=tile)
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32
    # the matmul identity: the same formula, 1e-5 of the squared scale
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5 * float((t * t).sum(1).max()))
    differ = gi.numpy() != np.asarray(wi)
    assert differ.sum() <= 2          # only a near-tie of rounding may differ
    assert (gi.numpy()[-20:] == np.arange(120, 140)).all()   # lowest index of a tie
    none = tbf.nn1(torch.from_numpy(t), torch.zeros(700, dtype=torch.bool), torch.from_numpy(q))
    assert bool((none[0] == 0).all()) and bool(torch.isinf(none[1]).all())


def test_rgb_to_lab_matches_jax(rng):
    rgb = np.concatenate([rng.uniform(size=(500, 3)), np.zeros((1, 3)), np.ones((1, 3)),
                          np.full((1, 3), 0.04045), np.full((1, 3), 0.003)]).astype(np.float32)
    got = t_rgb_to_lab(torch.from_numpy(rgb)).numpy()
    # Lab spans ~[0, 100]: 1e-4 absolute is float32 rounding of the power laws
    np.testing.assert_allclose(got, np.asarray(j_rgb_to_lab(jnp.asarray(rgb))), atol=1e-4)
    assert got[-3] == pytest.approx([100.0, 0.0, 0.0], abs=1e-2)


@pytest.mark.parametrize("backend", ["brute", "cell"])
def test_regularized_covariances(rng, backend):
    k = 15
    pts = structured_cloud(rng, 1200)
    mask = np.ones(1216, bool)
    mask[1200:] = False
    mask[::97] = False
    xyz = np.concatenate([pts, np.zeros((16, 3), np.float32)])
    xyz[~mask] = 0.0
    kw = dict(k=k, backend=backend, cell_cap=64, table_size=1 << 14, with_trunc=True)
    Cj, trj = jg.regularized_covariances(jnp.asarray(xyz), jnp.asarray(mask), **kw)
    Ct, trt = tg.regularized_covariances(torch.from_numpy(xyz), torch.from_numpy(mask), **kw)
    Cj, Ct = np.asarray(Cj), Ct.numpy()
    assert bool(trt) == bool(trj)
    np.testing.assert_array_equal(Ct[~mask], np.broadcast_to(np.eye(3, dtype=np.float32),
                                                             Ct[~mask].shape))
    # firm points: neighbours k and k+1 apart, lambda0 isolated
    live = xyz[mask]
    d2 = ((live[:, None, :] - live[None, :, :]) ** 2).sum(-1)
    d2.sort(axis=1)
    firm = np.zeros(len(xyz), bool)
    firm[mask] = (d2[:, k] - d2[:, k - 1]) > 1e-4 * d2[:, k]
    lam = np.linalg.eigvalsh(Ct.astype(np.float64))
    assert (np.abs(lam[mask][:, 1:] - 1.0) < 1e-3).all() and (lam[mask][:, 0] < 0.01).all()
    err = np.abs(Cj - Ct).reshape(len(xyz), -1).max(1)
    print(f"{backend}: firm {int(firm.sum())} of {int(mask.sum())}, max diff firm "
          f"{err[firm].max():.2e}, all {err.max():.2e}")
    assert firm.sum() > 0.95 * mask.sum()
    assert err[firm].max() <= 2e-5
    if backend == "cell":
        with pytest.raises(ValueError, match="explicit cell_size"):
            tg.regularized_covariances(torch.from_numpy(xyz), torch.from_numpy(mask),
                                       backend="cell", grid_dims=(8, 8, 8))


def test_few_neighbours_give_identity():
    xyz = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [0, 5.0, 0], [0, 0, 0]])
    mask = torch.tensor([True, True, False, False])
    C = tg.regularized_covariances(xyz, mask, k=3)
    np.testing.assert_array_equal(C.numpy(), np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)))


def _spd(rng, n):
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + 0.05 * np.eye(3, dtype=np.float32)).astype(np.float32)


def test_pair_information_and_gauss_newton(rng):
    """The same covariances, rotation, weights and pairs through both
    packages: M, then T and the twists of two Gauss-Newton steps, each within
    1e-5 of its norm."""
    n = 900
    Cq, Cs = _spd(rng, n), _spd(rng, n)
    w = (rng.uniform(size=n) > 0.1).astype(np.float32)
    T0 = np.asarray(jtf.se3_exp(jnp.asarray(0.5 * SMALL_XI)))
    sx = structured_cloud(rng, n)
    q = (sx @ T0[:3, :3].T + T0[:3, 3] + rng.normal(scale=0.02, size=(n, 3))).astype(np.float32)
    Mj = jg._pair_information(jb.to_lanes(jnp.asarray(Cq)), jb.to_lanes(jnp.asarray(Cs)),
                              jnp.asarray(T0[:3, :3]), jnp.asarray(w))
    Mt = tg._pair_information(torch.from_numpy(Cq), torch.from_numpy(Cs),
                              torch.from_numpy(T0[:3, :3].copy()), torch.from_numpy(w))
    Mj_n = np.asarray(jb.from_lanes(Mj))
    assert np.abs(Mt.numpy() - Mj_n).max() <= 1e-5 * np.abs(Mj_n).max()
    assert (Mt.numpy()[w == 0] == 0).all()
    Tj, xij = jg._mahalanobis_gn(jnp.eye(4, dtype=jnp.float32), jnp.asarray(sx).T,
                                 jnp.asarray(q).T, Mj, 2)
    Tt, xit = tg._mahalanobis_gn(torch.eye(4), torch.from_numpy(sx), torch.from_numpy(q), Mt, 2)
    assert xit.shape == (2, 6)
    for got, want in ((Tt, Tj), (xit[0], xij[0]), (xit, xij)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.linalg.norm(want)
    assert np.abs(Tt.numpy() - T0).max() < 5e-3            # and it solves the problem


GICP_CASES = {
    "brute": (dict(max_corr_dist=1.0, max_iterations=30), False),
    "brute_resampled": (dict(max_corr_dist=0.5, max_iterations=30), True),
    "brute_one_inner_step": (dict(max_corr_dist=0.5, max_iterations=30, inner_iterations=1),
                             True),
    "cell": (dict(max_corr_dist=0.5, max_iterations=30, corr_backend="cell", cell_cap=256,
                  cov_cell_cap=64, table_size=1 << 14), False),
    "cell_truncating": (dict(max_corr_dist=0.5, max_iterations=30, corr_backend="cell",
                             cell_cap=4, cov_cell_cap=64, table_size=1 << 14), True),
    "cell_dense_grids": (dict(max_corr_dist=0.5, max_iterations=30, corr_backend="cell",
                              cell_cap=256, grid_dims=(6, 6, 5), cov_cell_size=0.4,
                              cov_grid_dims=(13, 13, 9), cov_cell_cap=64), True),
}


@pytest.mark.parametrize("case", list(GICP_CASES))
def test_gicp_matches_jax(rng, case):
    kw, resample = GICP_CASES[case]
    src, tgt, T_true = _pair(rng, resample=resample)
    want = jg.gicp(jmake(jnp.asarray(src)), jmake(jnp.asarray(tgt)), **kw)
    got = tg.gicp(tmake(src, device="cpu"), tmake(tgt, device="cpu"), **kw)
    print(f"{case}: iterations jax {int(want.iterations)} port {int(got.iterations)}, "
          f"fitness {float(want.fitness):.3e} {float(got.fitness):.3e}, truncated "
          f"{bool(want.truncated)} {bool(got.truncated)}")
    assert got.transform.dtype == torch.float32 and got.iterations.dtype == torch.int32
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-3)
    assert bool(got.converged) == bool(want.converged)
    assert bool(got.truncated) == bool(want.truncated)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    assert float(got.fitness) == pytest.approx(float(want.fitness), rel=1e-2)
    if not bool(got.truncated):
        assert np.abs(got.transform.numpy() - T_true).max() < 0.03


def test_gicp_init_transform_and_iteration_limit(rng):
    src, tgt, T_true = _pair(rng, resample=True)
    init = np.asarray(jtf.se3_exp(jnp.asarray(0.5 * SMALL_XI)))
    kw = dict(max_corr_dist=0.5, max_iterations=1, inner_iterations=1)
    want = jg.gicp(jmake(jnp.asarray(src)), jmake(jnp.asarray(tgt)), jnp.asarray(init), **kw)
    got = tg.gicp(tmake(src, device="cpu"), tmake(tgt, device="cpu"),
                  torch.from_numpy(init.copy()), **kw)
    assert int(got.iterations) == int(want.iterations) == 1
    assert not bool(got.converged) and not bool(want.converged)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-5)


def _colored_pair(rng, n=800):
    xy = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    z = 0.05 * np.sin(3 * xy[:, 0]) * np.cos(3 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    rgb = np.stack([(xy[:, 0] + 1) / 2, (xy[:, 1] + 1) / 2, np.full(n, 0.5)], 1).astype(np.float32)
    return pts, rgb, np.float32([0.04, -0.03, 0.02])


@pytest.mark.parametrize("backend", ["brute", "cell"])
def test_gicp6d_matches_jax(rng, backend):
    pts, rgb, delta = _colored_pair(rng)
    n = len(pts)
    kw = dict(max_corr_dist=0.3, max_iterations=30)
    if backend == "cell":
        kw.update(corr_backend="cell", cand_k=8, cell_cap=64, table_size=1 << 14)
    want = jg.gicp6d(
        JCloud(xyz=jnp.asarray(pts), mask=jnp.ones(n, bool), attrs={"rgb": jnp.asarray(rgb)}),
        JCloud(xyz=jnp.asarray(pts + delta), mask=jnp.ones(n, bool),
               attrs={"rgb": jnp.asarray(rgb)}), **kw)
    ones = torch.ones(n, dtype=torch.bool)
    got = tg.gicp6d(
        TCloud(xyz=torch.from_numpy(pts), mask=ones, attrs={"rgb": torch.from_numpy(rgb)}),
        TCloud(xyz=torch.from_numpy(pts + delta), mask=ones,
               attrs={"rgb": torch.from_numpy(rgb)}), **kw)
    print(f"gicp6d {backend}: iterations jax {int(want.iterations)} port {int(got.iterations)}")
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-3)
    np.testing.assert_allclose(got.transform.numpy()[:3, 3], delta, atol=5e-3)
    assert bool(got.converged) == bool(want.converged) is True
    assert bool(got.truncated) == bool(want.truncated) is False
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    with pytest.raises(ValueError, match="requires 'rgb'"):
        tg.gicp6d(tmake(pts, device="cpu"), tmake(pts, device="cpu"))
