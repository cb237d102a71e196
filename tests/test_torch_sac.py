"""Parity of pcl_tpu_torch.sac (models and ransac) and
pcl_tpu_torch.segmentation with the JAX package on the CPU.

Models. Each of the 18 models fits the same batch of samples (points drawn
on or near the model, with normals where the model needs them, and
degenerate samples); NaN coefficients must fall on the same samples, and the
finite ones agree to 1e-4 relative and absolute (float32 cross products,
determinants and small linear solves in another order; the ellipse's conic,
a 5x5 normal-equation solve, to 1e-3). ``distances``, ``refine`` and
``project`` then run on both sides from the JAX package's coefficients, to
1e-4 (the sphere's and circle's three Gauss-Newton steps to 1e-3).

ransac. The port cannot draw JAX's random streams, so each test draws the
JAX package's indices (and the RRANSAC subset) with the same
``jax.random`` calls ``pcl_tpu.sac.ransac`` makes, and feeds them to
``ransac_core``: the best hypothesis is the same, coefficients to 1e-4,
scores to 1e-4 relative, and inliers equal except on points within 1e-5 of
the threshold. LMedS runs on an even count of valid points, where the median
averages the two middle values.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import sac as jsac
from pcl_tpu import segmentation as jseg
from pcl_tpu.core.cloud import make_cloud as jmake

from pcl_tpu_torch import sac as tsac
from pcl_tpu_torch import segmentation as tseg
from pcl_tpu_torch.core.cloud import make_cloud as tmake

# ``sac.ransac`` names the function in both packages; the modules by path
jransac = importlib.import_module("pcl_tpu.sac.ransac")
transac = importlib.import_module("pcl_tpu_torch.sac.ransac")

B = 48


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rot(rng):
    q = _unit(rng.normal(size=4))
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _on_sphere(rng, m, c=(0.3, -0.2, 0.5), r=0.8):
    u = _unit(rng.normal(size=(B, m, 3)))
    return np.asarray(c) + r * u, u


def _on_cylinder(rng, m, r=0.6):
    R = _rot(rng)
    th = rng.uniform(0, 2 * np.pi, size=(B, m))
    h = rng.uniform(-1, 1, size=(B, m))
    local = np.stack([r * np.cos(th), r * np.sin(th), h], -1)
    nrm = np.stack([np.cos(th), np.sin(th), 0 * th], -1)
    return local @ R.T + 0.1, nrm @ R.T


def _on_cone(rng, m, alpha=0.5):
    th = rng.uniform(0, 2 * np.pi, size=(B, m))
    h = rng.uniform(0.3, 1.5, size=(B, m))
    rho = h * np.tan(alpha)
    pts = np.stack([rho * np.cos(th), rho * np.sin(th), h], -1)
    nrm = np.stack([np.cos(alpha) * np.cos(th), np.cos(alpha) * np.sin(th),
                    -np.sin(alpha) * np.ones_like(th)], -1)
    return pts + 0.2, nrm


def _on_torus(rng, m, R=1.0, r=0.3):
    u = rng.uniform(0, 2 * np.pi, size=(B, m))
    v = rng.uniform(0, 2 * np.pi, size=(B, m))
    pts = np.stack([(R + r * np.cos(v)) * np.cos(u), (R + r * np.cos(v)) * np.sin(u),
                    r * np.sin(v)], -1)
    nrm = np.stack([np.cos(v) * np.cos(u), np.cos(v) * np.sin(u), np.sin(v)], -1)
    return pts, nrm


def _on_ellipse(rng, m, a=1.2, b=0.5):
    R = _rot(rng)
    t = rng.uniform(0, 2 * np.pi, size=(B, m))
    pts = np.stack([a * np.cos(t), b * np.sin(t), 0 * t], -1) @ R.T + 0.3
    return pts + rng.normal(scale=1e-3, size=pts.shape), None


# models for which a sample that repeats a point is exactly degenerate (the
# others fit it, or rounding decides)
REPEAT_DEGENERATE = ("plane", "line", "stick", "sphere", "circle3d", "circle2d", "cylinder",
                     "perpendicular_plane", "parallel_plane", "parallel_line", "normal_plane",
                     "normal_parallel_plane", "normal_sphere")


def _near_axis(rng, m, planar):
    """Samples of planes whose normal (``planar``) or lines whose direction
    lies near z: half within the models' 0.2 rad, half anywhere."""
    pts = rng.uniform(-1, 1, size=(B, m, 3))
    if planar:
        pts[: B // 2, :, 2] = 0.1 * pts[: B // 2, :, 2]
    else:
        pts[: B // 2, :, :2] = 0.1 * pts[: B // 2, :, :2]
    return pts


def _samples(name, model, rng):
    """(samples [B, m, 3], normals or None): the model's own surface where a
    random sample would be degenerate or out of its limits, random points
    otherwise; for REPEAT_DEGENERATE models the first 4 samples repeat a
    point."""
    m = model.sample_size
    nrm = None
    if name in ("sphere", "normal_sphere"):
        pts, nrm = _on_sphere(rng, m)
    elif name == "cylinder":
        pts, nrm = _on_cylinder(rng, m)
    elif name == "cone":
        pts, nrm = _on_cone(rng, m)
    elif name == "torus":
        pts, nrm = _on_torus(rng, m)
    elif name == "ellipse3d":
        pts, nrm = _on_ellipse(rng, m)
    elif name in ("perpendicular_plane", "normal_parallel_plane", "parallel_line"):
        pts = _near_axis(rng, m, planar=name != "parallel_line")
    elif name == "parallel_plane":
        pts = _near_axis(rng, m, planar=False)
    else:
        pts = rng.uniform(-1, 1, size=(B, m, 3))
    if model.needs_normals and nrm is None:
        nrm = _unit(rng.normal(size=(B, m, 3)))
    pts = pts.copy()
    if name in REPEAT_DEGENERATE:
        pts[:4, 1] = pts[:4, 0]
        if nrm is not None:
            nrm = nrm.copy()
            nrm[:4, 1] = nrm[:4, 0]
    return pts.astype(np.float32), None if nrm is None else nrm.astype(np.float32)


MODELS = {
    "plane": "PlaneModel", "line": "LineModel", "stick": "StickModel", "sphere": "SphereModel",
    "circle3d": "CircleModel3D", "cylinder": "CylinderModel", "circle2d": "Circle2DModel",
    "cone": "ConeModel", "torus": "TorusModel", "ellipse3d": "Ellipse3DModel",
    "perpendicular_plane": "PerpendicularPlaneModel", "parallel_plane": "ParallelPlaneModel",
    "parallel_line": "ParallelLineModel", "normal_plane": "NormalPlaneModel",
    "normal_parallel_plane": "NormalParallelPlaneModel", "normal_sphere": "NormalSphereModel",
    "registration": "RegistrationModel",
}


def _pair(name):
    return getattr(jsac, MODELS[name])(), getattr(tsac, MODELS[name])()


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    rng = np.random.default_rng(sorted(MODELS).index(name))
    jm, tm = _pair(name)
    assert tm.sample_size == jm.sample_size and tm.coeff_size == jm.coeff_size
    assert tm.needs_normals == jm.needs_normals
    samples, nrm = _samples(name, tm, rng)
    xyz = rng.uniform(-1.5, 1.5, size=(400, 3)).astype(np.float32)
    pn = _unit(rng.normal(size=(400, 3))).astype(np.float32)
    fit_tol = 1e-3 if name == "ellipse3d" else 1e-4
    j = lambda a: None if a is None else jnp.asarray(a)          # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)     # noqa: E731
    if name == "registration":
        R, tr = _rot(rng).astype(np.float32), np.float32([0.3, -0.1, 0.2])
        tgt = samples @ R.T + tr
        want = jm.fit(j(samples), target_samples=j(tgt))
        got = tm.fit(t(samples), target_samples=t(tgt))
        _close(got, want, fit_tol)
        coeffs = np.asarray(want)
        txyz = xyz @ R.T + tr + rng.normal(scale=0.01, size=xyz.shape).astype(np.float32)
        _close(tm.distances(t(coeffs), t(xyz), target_xyz=t(txyz)),
               jm.distances(j(coeffs), j(xyz), target_xyz=j(txyz)), 1e-4)
        w = (rng.random(400) < 0.7).astype(np.float32)
        _close(tm.refine(t(coeffs[5]), t(xyz), t(w), target_xyz=t(txyz)),
               jm.refine(j(coeffs[5]), j(xyz), j(w), target_xyz=j(txyz)), 1e-4)
        with pytest.raises(ValueError, match="requires"):
            tm.fit(t(samples))
        return
    want = jm.fit(j(samples), j(nrm))
    got = tm.fit(t(samples), t(nrm))
    assert got.shape == (B, tm.coeff_size)
    _close(got, want, fit_tol)
    coeffs = np.asarray(want)
    if name in REPEAT_DEGENERATE:
        assert np.isnan(coeffs[:4]).all()
    assert np.isfinite(coeffs[4:]).all(axis=1).sum() >= 8
    if getattr(jm, "scores_with_normals", False):
        _close(tm.distances(t(coeffs), t(xyz), normals=t(pn)),
               jm.distances(j(coeffs), j(xyz), normals=j(pn)), 1e-4)
    _close(tm.distances(t(coeffs), t(xyz)), jm.distances(j(coeffs), j(xyz)), 1e-4)
    ok = np.nonzero(np.isfinite(coeffs).all(axis=1))[0][0]
    w = (rng.random(400) < 0.6).astype(np.float32)
    # the Gauss-Newton refinements run on the model's own points
    pts = xyz
    if name in ("sphere", "normal_sphere"):
        pts = (np.asarray([0.3, -0.2, 0.5]) + 0.8 * _unit(rng.normal(size=(400, 3)))).astype(
            np.float32)
    elif name == "circle2d":
        th = rng.uniform(0, 2 * np.pi, 400)
        pts = np.stack([0.4 + 0.7 * np.cos(th), -0.1 + 0.7 * np.sin(th), th], 1).astype(np.float32)
    ref_tol = 1e-3 if name in ("sphere", "normal_sphere", "circle2d") else 1e-4
    _close(tm.refine(t(coeffs[ok]), t(pts), t(w)), jm.refine(j(coeffs[ok]), j(pts), j(w)),
           ref_tol)
    try:
        want_p = jm.project(j(coeffs[ok:ok + 1]), j(xyz))
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            tm.project(t(coeffs[ok:ok + 1]), t(xyz))
    else:
        _close(tm.project(t(coeffs[ok:ok + 1]), t(xyz)), want_p, 1e-4)
    if tm.needs_normals and name not in ("normal_plane", "normal_parallel_plane",
                                         "normal_sphere"):
        with pytest.raises(ValueError, match="requires normals"):
            tm.fit(t(samples))


def _plane_scene(seed, n_in=700, n_out=300):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1, 1, size=(n_in, 2))
    pts = np.stack([uv[:, 0], uv[:, 1], 0.3 * uv[:, 0] - 0.5], 1)
    pts += rng.normal(scale=0.005, size=pts.shape)
    out = rng.uniform(-2, 2, size=(n_out, 3))
    xyz = np.concatenate([pts, out]).astype(np.float32)
    mask = np.ones(len(xyz), bool)
    mask[[3, 10, 500, 900]] = False         # 996 valid points: an even count
    xyz[~mask] = 0.0
    return xyz, mask


def _jax_draws(key, n_hyp, m, mask, quality=None, frac=0.1):
    """The indices and subset pcl_tpu.sac.ransac draws for ``key``."""
    n = len(mask)
    w = jnp.asarray(mask).astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    k_idx, k_sub = jax.random.split(key)
    if quality is not None:
        idx = jransac._prosac_indices(k_idx, n_hyp, m, n, jnp.asarray(quality), jnp.asarray(mask))
    else:
        idx = jransac._sample_indices(k_idx, n_hyp, m, n, probs)
    sub = jax.random.bernoulli(k_sub, frac, (n,)) & jnp.asarray(mask)
    return torch.from_numpy(np.asarray(idx)), torch.from_numpy(np.asarray(sub))


def _same_result(got, want, xyz, thr, dist):
    assert bool(got.valid) == bool(want.valid)
    np.testing.assert_allclose(got.coefficients.numpy(), np.asarray(want.coefficients),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-4, atol=1e-6)
    d = np.asarray(dist)
    firm = np.abs(d - thr) > 1e-5
    np.testing.assert_array_equal(got.inliers.numpy()[firm], np.asarray(want.inliers)[firm])
    assert abs(int(got.num_inliers) - int(want.num_inliers)) <= int((~firm).sum())


@pytest.mark.parametrize("method", ["ransac", "msac", "lmeds", "rransac", "rmsac", "mlesac",
                                    "prosac"])
def test_ransac_core_matches_jax(method):
    xyz, mask = _plane_scene(5)
    key = jax.random.PRNGKey(11)
    quality = None
    if method == "prosac":
        quality = -np.abs(xyz[:, 2] - (0.3 * xyz[:, 0] - 0.5)).astype(np.float32)
    jm, tm = jsac.PlaneModel(), tsac.PlaneModel()
    meth = "ransac" if method == "prosac" else method
    want = jsac.ransac(jm, jnp.asarray(xyz), jnp.asarray(mask), 0.02, key=key, n_hypotheses=128,
                       method=meth, quality=None if quality is None else jnp.asarray(quality))
    idx, sub = _jax_draws(key, 128, 3, mask, quality)
    got = tsac.ransac_core(tm, torch.from_numpy(xyz), torch.from_numpy(mask), 0.02, idx, sub,
                           method=meth)
    dist = jm.distances(want.coefficients[None], jnp.asarray(xyz))[0]
    _same_result(got, want, xyz, 0.02, dist)
    # without refinement the best hypothesis' own coefficients come back
    want = jsac.ransac(jm, jnp.asarray(xyz), jnp.asarray(mask), 0.02, key=key, n_hypotheses=128,
                       method=meth, refine=False,
                       quality=None if quality is None else jnp.asarray(quality))
    got = tsac.ransac_core(tm, torch.from_numpy(xyz), torch.from_numpy(mask), 0.02, idx, sub,
                           method=meth, refine=False)
    dist = jm.distances(want.coefficients[None], jnp.asarray(xyz))[0]
    _same_result(got, want, xyz, 0.02, dist)


def test_ransac_core_normals_and_pairs_match_jax():
    """A model scored with normals and the paired registration model."""
    rng = np.random.default_rng(6)
    xyz, mask = _plane_scene(6)
    nrm = np.tile(_unit(np.float32([-0.3, 0.0, 1.0])), (len(xyz), 1)).astype(np.float32)
    nrm[700:] = _unit(rng.normal(size=(300, 3)))
    key = jax.random.PRNGKey(2)
    for jm, tm in (_pair("normal_plane"), _pair("sphere")):
        want = jsac.ransac(jm, jnp.asarray(xyz), jnp.asarray(mask), 0.03, key=key,
                           n_hypotheses=64, normals=jnp.asarray(nrm), method="msac")
        idx, sub = _jax_draws(key, 64, jm.sample_size, mask)
        got = tsac.ransac_core(tm, torch.from_numpy(xyz), torch.from_numpy(mask), 0.03, idx,
                               sub, method="msac", normals=torch.from_numpy(nrm))
        np.testing.assert_allclose(got.coefficients.numpy(), np.asarray(want.coefficients),
                                   rtol=1e-3, atol=1e-3)
        assert int(got.num_inliers) == pytest.approx(int(want.num_inliers), abs=2)
    R, tr = _rot(rng).astype(np.float32), np.float32([1.0, -0.5, 0.2])
    tgt = xyz @ R.T + tr
    tgt[:200] = rng.uniform(-2, 2, size=(200, 3))         # wrong correspondences
    jm, tm = _pair("registration")
    want = jsac.ransac(jm, jnp.asarray(xyz), jnp.asarray(mask), 0.05, key=key, n_hypotheses=64,
                       target_xyz=jnp.asarray(tgt))
    idx, sub = _jax_draws(key, 64, 3, mask)
    got = tsac.ransac_core(tm, torch.from_numpy(xyz), torch.from_numpy(mask), 0.05, idx, sub,
                           target_xyz=torch.from_numpy(tgt))
    dist = jm.distances(want.coefficients, jnp.asarray(xyz), target_xyz=jnp.asarray(tgt))
    _same_result(got, want, xyz, 0.05, dist)


def test_nanmedian_averages_the_middle_pair():
    x = torch.tensor([[4.0, 1.0, float("nan"), 3.0, 2.0, float("nan")],
                      [5.0, float("nan"), 1.0, 2.0, 7.0, 3.0],
                      [float("nan")] * 6])
    got = transac.nanmedian(x)
    want = np.asarray(jnp.nanmedian(jnp.asarray(x.numpy()), axis=-1))
    np.testing.assert_array_equal(got.numpy()[:2], want[:2])
    assert got[0] == 2.5 and got[1] == 3.0 and torch.isnan(got[2])
    assert float(torch.nanmedian(x[0])) == 2.0          # torch's lower middle value


@pytest.mark.parametrize("method", ["ransac", "rransac"])
def test_sampler(method):
    xyz, mask = _plane_scene(7)
    tm = tsac.PlaneModel()
    g = torch.Generator().manual_seed(3)
    idx, sub = tsac.draw_samples(tm, torch.from_numpy(mask), 4000, method, 0.25, gen=g)
    assert idx.shape == (4000, 3) and idx.dtype == torch.int32
    assert torch.from_numpy(mask)[idx.long()].all()
    assert len(torch.unique(idx)) > 900
    if method == "rransac":
        assert 0.15 < sub.float().mean() < 0.35 and not sub[~torch.from_numpy(mask)].any()
    else:
        assert not sub.any()
    again = tsac.draw_samples(tm, torch.from_numpy(mask), 4000, method, 0.25)
    assert torch.equal(again[0], tsac.draw_samples(tm, torch.from_numpy(mask), 4000, method,
                                                   0.25)[0])
    # PROSAC: hypothesis b draws among the m_b best points
    quality = torch.from_numpy(-np.abs(xyz[:, 2]))
    pidx, _ = tsac.draw_samples(tm, torch.from_numpy(mask), 64, quality=quality, gen=g)
    order, n_valid = transac._prosac_order(quality, torch.from_numpy(mask))
    rank = torch.argsort(order)
    m_b = transac._prosac_sizes(64, 3, n_valid)
    assert (rank[pidx.long()] < m_b[:, None]).all()
    assert (rank[pidx[0].long()] < 3).all()


def test_ransac_finds_the_plane():
    xyz, mask = _plane_scene(8)
    res = tsac.ransac(tsac.PlaneModel(), torch.from_numpy(xyz), torch.from_numpy(mask), 0.02,
                      n_hypotheses=256)
    n = res.coefficients[:3].numpy()
    assert bool(res.valid) and abs(n @ _unit(np.float32([-0.3, 0, 1]))) > 0.999
    assert int(res.num_inliers) > 650


def test_sac_segmentation_and_differences_match_jax():
    xyz, mask = _plane_scene(9)
    jc = jmake(jnp.asarray(xyz), jnp.asarray(mask))
    tc = tmake(xyz, mask, device="cpu")
    key = jax.random.PRNGKey(4)
    want = jseg.sac_segmentation(jc, jsac.PlaneModel(), 0.02, key=key, n_hypotheses=64)
    idx, sub = _jax_draws(key, 64, 3, mask)
    got = tsac.ransac_core(tsac.PlaneModel(), tc.xyz, tc.mask, 0.02, idx, sub)
    np.testing.assert_allclose(got.coefficients.numpy(), np.asarray(want.coefficients),
                               rtol=1e-4, atol=1e-4)
    seg = tseg.sac_segmentation(tc, tsac.PlaneModel(), 0.02, n_hypotheses=64)
    assert bool(seg.valid) and int(seg.num_inliers) > 650
    with pytest.raises(ValueError, match="requires normals"):
        tseg.sac_segmentation(tc, tsac.CylinderModel(), 0.02)
    # segment_differences: the points of a farther than 0.05 from b (the
    # brute 1-NN; the port's exact distance against the JAX matmul identity,
    # ROADMAP C1, so points within 1e-5 of the threshold are left out)
    rng = np.random.default_rng(9)
    b = xyz[:600] + rng.normal(scale=0.04, size=(600, 3)).astype(np.float32)
    want = jseg.segment_differences(jc, jmake(jnp.asarray(b)), 0.05)
    got = tseg.segment_differences(tc, tmake(b, device="cpu"), 0.05)
    d = np.sqrt(((xyz[:, None] - b[None]) ** 2).sum(-1)).min(1)
    firm = np.abs(d - 0.05) > 1e-5
    np.testing.assert_array_equal(got.mask.numpy()[firm], np.asarray(want.mask)[firm])
    assert 0 < int(got.mask.sum()) < int(mask.sum())
