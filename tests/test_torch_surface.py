"""Parity of the port's ``surface/`` with the JAX package on the CPU:
reconstruction (Hoppe, organized fast mesh), hulls, MLS and its upsampling
modes, greedy projection triangulation and ear clipping, Poisson, RBF and
the processing functions. Both packages get the same seeded points with the
same normals (``torch_surface_scenes``).

Tolerances:
- Hoppe (ROADMAP C55): the JAX package's CPU 1-NN takes the matmul identity,
  the port the exact distance (kernel B1's contract), so a grid point whose
  two nearest points lie within 8 ulp of ``|q|^2 + |t|^2`` may take the
  other; the SDF agrees to 1e-6 elsewhere (grid samples may differ in their
  last bit: XLA reassociates ``linspace``). The meshes agree exactly (the
  triangles) and to 1e-5 (the vertices) when no SDF sign differs; the
  count of near-tie grid points is printed.
- MLS: positions to 1e-5, normals to 1e-4, curvature to 1e-5 (a batched
  6x6 solve in each package's LAPACK order).
- Poisson (C56): ``chi`` to 1e-5 of its largest magnitude (``torch.fft``
  against XLA's FFT and the scatter order), the iso value to 1e-5 relative;
  meshes by a two-sided Hausdorff distance within a tenth of a cell and the
  sign flips of ``chi - iso`` counted (at most 0.1% of the grid).
- Hulls, GP3, RBF, ear clipping, texture mapping: equal (host code, or
  decisions far from their cuts on these scenes).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_surface_scenes as S
from pcl_tpu.surface import hulls as jh
from pcl_tpu.surface import mls as jm
from pcl_tpu.surface import mls_upsampling as jmu
from pcl_tpu.surface import poisson as jp
from pcl_tpu.surface import processing as jpr
from pcl_tpu.surface import rbf as jrbf
from pcl_tpu.surface import reconstruction as jr
from pcl_tpu.surface import triangulation as jt
from pcl_tpu.core.cloud import Cloud as JCloud

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.surface import hulls as th
from pcl_tpu_torch.surface import mls as tm
from pcl_tpu_torch.surface import mls_upsampling as tmu
from pcl_tpu_torch.surface import poisson as tp
from pcl_tpu_torch.surface import processing as tpr
from pcl_tpu_torch.surface import rbf as trbf
from pcl_tpu_torch.surface import reconstruction as tr
from pcl_tpu_torch.surface import triangulation as tt


@pytest.fixture(scope="module")
def ball():
    xyz, nrm = S.sphere(0, 800)
    return (xyz, nrm) + S.clouds(xyz, nrm, capacity=832)


def _a(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def hoppe_firm(xyz, q, margin_ulp=8):
    """Grid points whose nearest point beats the runner-up by ``margin_ulp``
    ulp of ``|q|^2 + |t|^2`` (float64 distances)."""
    d = ((q[:, None, :].astype(np.float64) - xyz[None].astype(np.float64)) ** 2).sum(-1)
    part = np.partition(d, 1, axis=1)
    scale = (q.astype(np.float64) ** 2).sum(1) + (xyz.astype(np.float64) ** 2).sum(1).max()
    return part[:, 1] - part[:, 0] > margin_ulp * 2.0 ** -23 * scale


def test_hoppe_sdf_and_mesh_match_jax(ball):
    xyz, _, jc, tc = ball
    R = 24
    lo, hi = tr.hoppe_grid_bounds(tc, 0.05)
    sj = np.asarray(jr.hoppe_signed_distance(jc, jnp.asarray(lo), jnp.asarray(hi), resolution=R))
    st = _a(tr.hoppe_signed_distance(tc, lo, hi, R))
    q = _a(tr.grid_points(torch.from_numpy(lo), torch.from_numpy(hi), R))
    firm = hoppe_firm(xyz, q).reshape(R, R, R)
    print(f"Hoppe: {int((~firm).sum())} of {R ** 3} grid points near a 1-NN tie")
    assert firm.mean() > 0.95
    np.testing.assert_allclose(st[firm], sj[firm], atol=1e-6)
    assert np.array_equal(st < 0, sj < 0)
    Vj, Fj = jr.reconstruct_hoppe(jc, resolution=R)
    Vt, Ft = tr.reconstruct_hoppe(tc, resolution=R)
    assert np.array_equal(Ft, Fj) and len(Ft) > 1000
    np.testing.assert_allclose(Vt, Vj, atol=1e-5)


def test_surface_nets_is_the_jax_copy():
    rng = np.random.default_rng(3)
    sdf = rng.normal(size=(9, 9, 9)).astype(np.float32)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    for a, b in zip(tr.surface_nets(sdf, lo, hi), jr.surface_nets(sdf, lo, hi)):
        assert np.array_equal(a, b)


def test_organized_fast_mesh_matches_jax():
    rng = np.random.default_rng(4)
    H, W = 12, 16
    xyz = np.concatenate([np.mgrid[0:H, 0:W].transpose(1, 2, 0) * 0.01,
                          1 + 0.05 * rng.random((H, W, 1))], -1).reshape(-1, 3)
    xyz = xyz.astype(np.float32)
    m = rng.random(H * W) > 0.1
    xyz = np.where(m[:, None], xyz, 0).astype(np.float32)      # padding rows are zero
    jc = JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(m), width=W, height=H)
    tc = make_cloud(xyz, m, width=W, height=H, device="cpu")
    for max_edge in (np.inf, 0.03):
        Vj, Fj = jr.organized_fast_mesh(jc, max_edge)
        Vt, Ft = tr.organized_fast_mesh(tc, max_edge)
        assert np.array_equal(Ft, Fj) and np.array_equal(Vt, Vj) and len(Ft) > 100


@pytest.mark.parametrize("kind", ["convex", "concave2d", "concave3d"])
def test_hulls_match_jax(ball, kind):
    _, _, jc, tc = ball
    call = {"convex": lambda m, c: m.convex_hull(c, dim=3),
            "concave2d": lambda m, c: m.concave_hull(c, 0.1),
            "concave3d": lambda m, c: m.concave_hull(c, 0.2, dim=3)}[kind]
    for a, b in zip(call(th, tc), call(jh, jc)):
        assert np.array_equal(a, b)
    assert len(call(th, tc)[1]) > 10


@pytest.mark.parametrize("order", [1, 2])
def test_moving_least_squares_matches_jax(ball, order):
    _, _, jc, tc = ball
    oj = jm.moving_least_squares(jc, 0.12, k=32, polynomial_order=order)
    ot = tm.moving_least_squares(tc, 0.12, k=32, polynomial_order=order)
    np.testing.assert_allclose(_a(ot.xyz), np.asarray(oj.xyz), atol=1e-5)
    np.testing.assert_allclose(_a(ot.attrs["normal"]), np.asarray(oj.attrs["normal"]), atol=1e-4)
    np.testing.assert_allclose(_a(ot.attrs["curvature"]), np.asarray(oj.attrs["curvature"]),
                               atol=1e-5)
    assert np.array_equal(_a(ot.mask), np.asarray(oj.mask))


def test_mls_project_matches_jax(ball):
    xyz, _, jc, tc = ball
    q = xyz[::7] + np.float32(0.01)
    pj = jmu.mls_project(jc, jnp.asarray(q), 0.12, k=32)
    pt = tmu.mls_project(tc, torch.from_numpy(q), 0.12, k=32)
    np.testing.assert_allclose(_a(pt[0]), np.asarray(pj[0]), atol=1e-5)
    np.testing.assert_allclose(_a(pt[1]), np.asarray(pj[1]), atol=1e-4)
    assert np.array_equal(_a(pt[2]), np.asarray(pj[2]))
    dj = jmu.mls_distinct_cloud(jc, jc, 0.12, k=32)
    dt = tmu.mls_distinct_cloud(tc, tc, 0.12, k=32)
    np.testing.assert_allclose(_a(dt.xyz), np.asarray(dj.xyz), atol=1e-5)


@pytest.mark.parametrize("mode", ["local_plane", "random_density", "voxel_dilation"])
def test_mls_upsampling_matches_jax(ball, mode):
    """The sample layouts are host numpy in both (the random one from the
    same numpy seed, ROADMAP C61); the projections to 1e-5."""
    _, _, jc, tc = ball
    fn, kw = {"local_plane": ("mls_upsample_local_plane",
                              dict(upsampling_radius=0.03, step_size=0.02)),
              "random_density": ("mls_upsample_random_density",
                                 dict(upsampling_radius=0.03, density=2000.0, seed=5)),
              "voxel_dilation": ("mls_upsample_voxel_dilation", dict(voxel_size=0.05))}[mode]
    cj = getattr(jmu, fn)(jc, 0.12, k=32, **kw)
    ct = getattr(tmu, fn)(tc, 0.12, k=32, **kw)
    assert np.array_equal(_a(ct.mask), np.asarray(cj.mask)) and int(ct.count) > 1000
    np.testing.assert_allclose(_a(ct.xyz), np.asarray(cj.xyz), atol=1e-5)
    np.testing.assert_allclose(_a(ct.attrs["normal"]), np.asarray(cj.attrs["normal"]), atol=1e-4)


def test_greedy_projection_triangulation_matches_jax(ball):
    _, _, jc, tc = ball
    Vj, Fj = jt.greedy_projection_triangulation(jc, 0.2, k=16)
    Vt, Ft = tt.greedy_projection_triangulation(tc, 0.2, k=16)
    assert np.array_equal(Vt, Vj) and np.array_equal(Ft, Fj) and len(Ft) > 1000


def test_ear_clipping_matches_jax():
    rng = np.random.default_rng(6)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
    rad = rng.uniform(0.5, 1.0, 12)
    verts = np.stack([rad * np.cos(ang), rad * np.sin(ang), 0.1 * rad], 1).astype(np.float32)
    polys = [np.arange(12), np.arange(12)[::-1][:5], np.array([0, 1])]
    assert np.array_equal(tt.ear_clipping(verts, polys[0]), jt.ear_clipping(verts, polys[0]))
    got = tt.triangulate_mesh_polygons(verts, polys)
    assert np.array_equal(got, jt.triangulate_mesh_polygons(verts, polys))
    assert got.shape == (10 + 3, 3)


def test_poisson_matches_jax(ball):
    _, _, jc, tc = ball
    R = 32
    gmin, _, cell, _ = tp.poisson_bounds(tc, 5, 1.15)
    cj, ij, oj = jp._indicator_grid(jc.xyz, jc.mask, jc.attrs["normal"], jnp.asarray(gmin),
                                    jnp.asarray(cell), R)
    ct, it, ot = tp.indicator_grid(tc.xyz, tc.mask, tc.attrs["normal"], torch.from_numpy(gmin),
                                   torch.from_numpy(cell), R)
    cj, ct = np.asarray(cj), _a(ct)
    scale = np.abs(cj).max()
    assert np.abs(ct - cj).max() <= 1e-5 * scale
    assert abs(float(it) - float(ij)) <= 1e-5 * abs(float(ij))
    assert np.array_equal(_a(ot), np.asarray(oj))
    flips = int((((ct - float(it)) < 0) != ((cj - float(ij)) < 0)).sum())
    print(f"Poisson: {flips} of {R ** 3} grid signs differ")
    assert flips <= 1e-3 * R ** 3
    Vj, Fj = jp.poisson_reconstruction(jc, depth=5)
    Vt, Ft = tp.poisson_reconstruction(tc, depth=5)
    from scipy.spatial import cKDTree

    haus = max(cKDTree(Vj).query(Vt)[0].max(), cKDTree(Vt).query(Vj)[0].max())
    assert haus <= 0.1 * float(cell.max()) and abs(len(Ft) - len(Fj)) <= 0.01 * len(Fj)


def test_marching_cubes_rbf_matches_jax(ball):
    """The subsample from the same numpy seed (C61). The r^3 kernel's dense
    system is ill-conditioned, and each package's LAPACK solves it in its own
    order: the field agrees to 2e-3 of its largest value (measured 1.0e-3),
    the grid's signs where the field clears that, and the meshes within a
    tenth of a cell (two-sided Hausdorff)."""
    from scipy.spatial import cKDTree

    _, _, jc, tc = ball
    centers, values, gmin, gmax = trbf.rbf_constraints(tc, 0.05, 100, 0.15, 0)
    fj = np.asarray(jrbf._rbf_field(jnp.asarray(centers), jnp.asarray(values), jnp.asarray(gmin),
                                    jnp.asarray(gmax), 20))
    ft = _a(trbf.rbf_field(*(torch.from_numpy(a) for a in (centers, values, gmin, gmax)), 20))
    tol = 2e-3 * np.abs(fj).max()
    assert np.abs(ft - fj).max() <= tol
    firm = np.abs(fj) > tol
    assert np.array_equal((ft < 0)[firm], (fj < 0)[firm])
    print(f"RBF: {int((~firm).sum())} of {fj.size} grid values within {tol:.2e} of 0")
    Vj, Fj = jrbf.marching_cubes_rbf(jc, resolution=20, max_centers=100)
    Vt, Ft = trbf.marching_cubes_rbf(tc, resolution=20, max_centers=100)
    cell = float((gmax - gmin).max()) / 19
    haus = max(cKDTree(Vj).query(Vt)[0].max(), cKDTree(Vt).query(Vj)[0].max())
    assert haus <= 0.1 * cell and len(Ft) > 500


def test_grid_projection_matches_jax(ball):
    """Hoppe's SDF (C55: near-tie grid points may differ) projected on the
    host: the same cells, points to 1e-4 (the gradient of a near-tie
    neighbour moves a few)."""
    _, _, jc, tc = ball
    gj, gt = jpr.grid_projection(jc, 16), tpr.grid_projection(tc, 16)
    assert gt.shape == gj.shape and len(gt) > 500
    assert (np.abs(gt - gj).max(1) <= 1e-4).mean() >= 0.99


def test_surfel_smoothing_matches_jax(ball):
    _, _, jc, tc = ball
    sj = jpr.surfel_smoothing(jc, 0.1, max_iterations=4)
    st = tpr.surfel_smoothing(tc, 0.1, max_iterations=4)
    np.testing.assert_allclose(_a(st.xyz), np.asarray(sj.xyz), atol=1e-4)
    np.testing.assert_allclose(_a(st.attrs["normal"]), np.asarray(sj.attrs["normal"]), atol=1e-3)


def test_bilateral_upsampling_matches_jax():
    rng = np.random.default_rng(7)
    d = rng.uniform(1, 2, (30, 40)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.2] = 0
    c = rng.uniform(0, 1, (30, 40, 3)).astype(np.float32)
    bj = np.asarray(jpr.bilateral_upsampling(jnp.asarray(d), jnp.asarray(c), sigma_color=0.3))
    bt = _a(tpr.bilateral_upsampling(torch.from_numpy(d), torch.from_numpy(c), sigma_color=0.3))
    np.testing.assert_allclose(bt, bj, rtol=1e-6)
    assert (bt > 0).all()


def test_texture_mapping_matches_jax(ball):
    xyz, _, jc, _ = ball
    V, F = jr.reconstruct_hoppe(jc, resolution=16)
    pose = np.eye(4)
    pose[2, 3] = 0.2
    for a, b in zip(tpr.texture_mapping(V, F, pose, 100.0, 100.0, 40.0, 30.0, 80, 60),
                    jpr.texture_mapping(V, F, pose, 100.0, 100.0, 40.0, 30.0, 80, 60)):
        assert np.array_equal(a, b)



def test_smoothed_surfaces_keypoints_match_jax(ball):
    """The JAX package's MLS at three radii handed to both packages: masks
    equal where every extremum test clears 1e-6 (the along-normal
    displacements are float32 sums of three products in either package)."""
    from pcl_tpu.keypoints import smoothed as jsk
    from pcl_tpu.search import bruteforce as jbf

    from pcl_tpu_torch.keypoints import smoothed_surfaces_keypoints

    xyz, _, jc, tc = ball
    smoothed = [jm.moving_least_squares(jc, r, k=32) for r in (0.06, 0.1, 0.15)]
    kj = jsk.smoothed_surfaces_keypoints(jc, smoothed, 0.1, k=12)
    kt = smoothed_surfaces_keypoints(
        tc, [make_cloud(np.asarray(s.xyz), np.asarray(s.mask), device="cpu") for s in smoothed],
        0.1, k=12)
    n = np.asarray(jc.attrs["normal"], np.float64)
    prev, D = np.asarray(jc.xyz, np.float64), []
    for s in smoothed:
        D.append(((np.asarray(s.xyz, np.float64) - prev) * n).sum(1))
        prev = np.asarray(s.xyz, np.float64)
    D = np.stack(D)
    idx, d2, ok = (np.array(a) for a in jbf.knn(jc.xyz, jc.mask, jc.xyz, 12))
    ok &= (d2 <= np.float32(0.1) ** 2) & np.asarray(jc.mask)[:, None]
    other = ok & (idx != np.arange(len(idx))[:, None])
    nb = D[:, idx]                                       # [scales, N, k]
    top = np.where(other[None], nb, -np.inf).max(2)
    bottom = np.where(other[None], nb, np.inf).min(2)
    firm = ((np.abs(D - top) > 1e-6) & (np.abs(D - bottom) > 1e-6)).all(0)
    firm &= np.abs(np.abs(D).max(0) - 1e-4) > 1e-6
    print(f"smoothed keypoints: {int((~firm).sum())} of {len(firm)} points with a near tie")
    assert np.array_equal(kt[firm], kj[firm]) and 5 <= kj.sum() < len(xyz)
