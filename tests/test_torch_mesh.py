"""Parity of the port's mesh smoothing and B-spline fitting with the JAX
package on the CPU.

- Mesh smoothing is host numpy in both packages (ROADMAP C62): equal bit for
  bit.
- B-splines: the frames come from ``eigh`` (ROADMAP C57): LAPACK builds and
  cuSOLVER may return an eigenvector with the other sign, which mirrors the
  parameter plane and the control net but not the surface in the world. The
  tests compare what does not depend on that sign: each package's surface
  at each data point's own parameters (world points, to 1e-4 m on a patch of
  1 m; float32 normal equations), the residuals, meshes by a two-sided
  Hausdorff distance, and the 2-D curve's control points (no frame) to 1e-4.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import torch_surface_scenes as S
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu_torch.core.cloud import make_cloud

jms = importlib.import_module("pcl_tpu.surface.mesh_smoothing")
jbs = importlib.import_module("pcl_tpu.surface.bspline")
tms = importlib.import_module("pcl_tpu_torch.surface.mesh_smoothing")
tbs = importlib.import_module("pcl_tpu_torch.surface.bspline")


def _a(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _patch_mesh(n=14, seed=0):
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:n, 0:n].astype(np.float64) / (n - 1)
    z = 0.15 * np.sin(3 * u) * np.cos(2 * v) + 0.005 * rng.normal(size=u.shape)
    xyz = np.stack([u, v, z], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = i[:-1, :-1].ravel(), i[:-1, 1:].ravel(), i[1:, :-1].ravel(), i[1:, 1:].ravel()
    return xyz, np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])


@pytest.mark.parametrize("fn, kw", [
    ("laplacian_smooth", {}), ("laplacian_smooth", {"fix_boundary": False}),
    ("taubin_smooth", {"n_iterations": 5}), ("boundary_vertices", {}),
    ("subdivide_linear", {}), ("decimate_cluster", {}), ("decimate_cluster", {"cell_size": 0.2}),
], ids=["laplacian", "laplacian_free", "taubin", "boundary", "subdivide", "decimate",
        "decimate_cell"])
def test_mesh_smoothing_is_the_jax_copy(fn, kw):
    V, F = _patch_mesh()
    a, b = getattr(tms, fn)(V, F, **kw), getattr(jms, fn)(V, F, **kw)
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def patch():
    rng = np.random.default_rng(1)
    n = 900
    u, v = rng.uniform(0, 1, n), rng.uniform(0, 0.7, n)
    z = 0.1 * np.sin(3 * u) * np.cos(2 * v) + 0.002 * rng.normal(size=n)
    xyz = np.stack([u, v, z], 1).astype(np.float32)
    # turned off the axes so that the frame is not the identity
    c, s = np.cos(0.4), np.sin(0.4)
    xyz = (xyz @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32).T).astype(np.float32)
    return xyz, S.clouds(xyz, capacity=960)


def _own_uv(surf, xyz):
    """The data points' parameters in the surface's own frame."""
    local = (np.asarray(xyz, np.float64) - _a(surf.centroid)) @ _a(surf.frame).T
    return ((local[:, :2] - _a(surf.origin)) / _a(surf.scale)).astype(np.float32)


def _world_at_data(mod, surf, xyz):
    return _a(mod.eval_bspline_surface(surf, np.clip(_own_uv(surf, xyz), 0, 1)))


@pytest.mark.parametrize("fit", ["plain", "iterated"])
def test_bspline_surface_matches_jax(patch, fit):
    xyz, (jc, tc) = patch
    if fit == "plain":
        sj, st = jbs.fit_bspline_surface(jc, 8, 8), tbs.fit_bspline_surface(tc, 8, 8)
    else:
        sj = jbs.fit_bspline_surface_iterated(jc, 8, 8)
        st = tbs.fit_bspline_surface_iterated(tc, 8, 8)
    pj, pt = _world_at_data(jbs, sj, xyz), _world_at_data(tbs, st, xyz)
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    rj, rt = np.linalg.norm(pj - xyz, axis=1), np.linalg.norm(pt - xyz, axis=1)
    assert abs(rt.mean() - rj.mean()) <= 1e-5 and rt.mean() < 0.01
    Vj, Fj = jbs.convert_surface_to_mesh(sj, 10)
    Vt, Ft = tbs.convert_surface_to_mesh(st, 10)
    Vj, Vt = np.asarray(Vj), _a(Vt)
    assert np.array_equal(Ft, Fj)
    assert max(cKDTree(Vj).query(Vt)[0].max(), cKDTree(Vt).query(Vj)[0].max()) <= 1e-4


def test_trimmed_bspline_surface_matches_jax(patch):
    """The trim lives in the parameter plane, mirrored with it (C57): the
    world points inside the trim, and their count within 1% of the grid
    (points on the trim's edge)."""
    xyz, (jc, tc) = patch
    tj, tt = jbs.fit_trimmed_bspline_surface(jc, 8, 8), tbs.fit_trimmed_bspline_surface(tc, 8, 8)
    pj, ij = (np.asarray(a) for a in jbs.eval_trimmed_bspline_surface(tj, 24, 24))
    pt, it = (_a(a) for a in tbs.eval_trimmed_bspline_surface(tt, 24, 24))
    assert abs(int(it.sum()) - int(ij.sum())) <= 0.01 * it.size and 0.3 < it.mean() < 1.0
    assert max(cKDTree(pj[ij]).query(pt[it])[0].max(),
               cKDTree(pt[it]).query(pj[ij])[0].max()) <= 0.05
    np.testing.assert_allclose(_world_at_data(tbs, tt.surface, xyz),
                               _world_at_data(jbs, tj.surface, xyz), atol=1e-4)
    uv = np.clip(_own_uv(tt.surface, xyz), 0, 1)
    assert _a(tbs.trimmed_surface_contains(tt, uv)).mean() >= 0.95


def test_bspline_curves_match_jax():
    rng = np.random.default_rng(2)
    th = np.sort(rng.uniform(-np.pi, np.pi, 300))
    p2 = np.stack([0.8 * np.cos(th), 0.5 * np.sin(th)], 1) + 0.01 * rng.normal(size=(300, 2))
    p2 = p2.astype(np.float32)
    m = rng.uniform(size=300) > 0.05
    cj = jbs.fit_bspline_curve2d(jnp.asarray(p2), jnp.asarray(m), 10)
    ct = tbs.fit_bspline_curve2d(p2, m, 10)
    np.testing.assert_allclose(_a(ct.control), np.asarray(cj.control), atol=1e-4)
    t = np.linspace(0, 1, 50, endpoint=False).astype(np.float32)
    np.testing.assert_allclose(_a(tbs.eval_bspline_curve2d(ct, t)),
                               np.asarray(jbs.eval_bspline_curve2d(cj, jnp.asarray(t))), atol=1e-4)
    p3 = np.concatenate([p2, 0.2 * p2[:, :1]], 1).astype(np.float32)
    dj = jbs.fit_bspline_curve3d(jnp.asarray(p3), jnp.asarray(m), 10)
    dt = tbs.fit_bspline_curve3d(p3, m, 10)
    ej = np.asarray(jbs.eval_bspline_curve3d(dj, jnp.asarray(t)))
    et = _a(tbs.eval_bspline_curve3d(dt, t))
    # the curve as a set (a mirrored frame runs it the other way round)
    assert max(cKDTree(ej).query(et)[0].max(), cKDTree(et).query(ej)[0].max()) <= 0.02
    assert np.abs(cKDTree(et).query(p3[m])[0]).mean() < 0.03
    assert np.array_equal(tbs.create_mesh_indices(4, 3, 7), jbs.create_mesh_indices(4, 3, 7))


def _leaves(x, name=""):
    """``(name, array)`` of every field of nested NamedTuples."""
    if hasattr(x, "_fields"):
        for f in x._fields:
            yield from _leaves(getattr(x, f), f"{name}.{f}")
    else:
        yield name, _a(x)


@pytest.mark.parametrize("fit", ["iterated", "trimmed"])
def test_bspline_fits_return_on_an_all_invalid_cloud(fit):
    """ROADMAP F5: with no valid point ``(u, v)`` is not finite; XLA's cast
    takes a NaN cell to 0, and the port's does the same (C71), so both
    packages return. Outputs agree within 1e-6 where both are finite; the
    origin is finite in neither. (The re-parameterised ``(u, v)`` are NaN;
    the JAX package's compiled clamp takes them to a bound, so its control
    points come out finite where the port's are NaN.)"""
    xyz = np.random.default_rng(3).uniform(size=(64, 3)).astype(np.float32)
    jc = JCloud(xyz=jnp.asarray(xyz), mask=jnp.zeros(64, bool))
    tc = make_cloud(xyz, np.zeros(64, bool), device="cpu")
    fn = {"iterated": "fit_bspline_surface_iterated", "trimmed": "fit_trimmed_bspline_surface"}
    sj, st = getattr(jbs, fn[fit])(jc, 8, 8), getattr(tbs, fn[fit])(tc, 8, 8)
    n_both = 0
    for (name, b), (_, a) in zip(_leaves(sj), _leaves(st)):
        assert a.shape == b.shape, name
        fin = np.isfinite(a) & np.isfinite(b)
        assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= 1e-6, name
        n_both += int(fin.sum())
        if name.endswith("origin"):
            assert not np.isfinite(a).any() and not np.isfinite(b).any()
    assert n_both >= 12          # the frame, the centroid and the scale at least
