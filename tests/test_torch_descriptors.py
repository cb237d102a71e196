"""Parity of the port's local descriptors with the JAX package on the CPU:
BOARD and FLARE frames, 3DSC (through its core, on the JAX package's own
draw) and USC, RoPS on a cloud and on a triangle mesh, spin images (both
forms, the three domains), principal curvatures, boundary points,
difference of normals, moments of inertia and invariants, RSD and GRSD, and
feature persistence.

Both packages get the same points and the JAX package's normals; their
brute neighbour lists are bitwise equal (ROADMAP F2). Rounding differs in
eigenvectors (C9), dot products and histogram sums, so:

- frames are compared to 1e-4 where the JAX package's choice is firm: the
  eigenvalues 5% apart, and for BOARD and FLARE the chosen neighbour's
  score more than 1e-5 above the runner-up's (an argmax over near-equal
  scores picks either);
- binned descriptors are compared to 1e-5 on rows where no neighbour lies
  within 1e-4 (in bins) of a bin edge in float64 from the JAX frames (C45);
  the other rows are counted and printed;
- continuous values (curvatures, moments, radii) to 1e-5 of their scale;
- the angular spin image divides sums of ``arccos |cos|``, which loses half
  its digits as ``|cos|`` nears 1 (``sqrt(2 ulp)`` ~ 3.5e-4 rad): 1e-3.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
import torch_feature_scenes as S
from pcl_tpu.core import geometry as jgeo
from pcl_tpu.features import local_misc as jlm
from pcl_tpu.features import lrf as jlrf
from pcl_tpu.features import persistence as jpers
from pcl_tpu.features import rops as jrops
from pcl_tpu.features import rsd as jrsd
from pcl_tpu.features import shape_context as jsc
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch import features as tfeat
from pcl_tpu_torch.features import local_misc as tlm
from pcl_tpu_torch.features import lrf as tlrf
from pcl_tpu_torch.features import persistence as tpers
from pcl_tpu_torch.features import rops as trops
from pcl_tpu_torch.features import rsd as trsd
from pcl_tpu_torch.features import shape_context as tsc

R = 0.35
EPS = 1e-4


@pytest.fixture(scope="module")
def scene():
    xyz = S.street_corner(0, 1500)
    jc, tc = S.clouds(xyz, capacity=1536)
    idx, d2, valid, _ = (np.asarray(v) for v in jbf.radius(jc.xyz, jc.mask, jc.xyz, R, cap=64))
    mask = np.asarray(jc.mask)
    return dict(jc=jc, tc=tc, xyz=np.asarray(jc.xyz), nrm=np.asarray(jc.attrs["normal"]),
                mask=mask, idx=idx, d2=d2, valid=valid & mask[:, None])


def _rows(a):
    a = np.asarray(a, np.float64)
    return a.reshape(a.shape[0], -1)


def _check(name, t, j, firm, tol, share=0.5):
    t, j = (_rows(x) for x in (t, j))
    print(S.count_line(name, firm))
    assert firm.sum() >= share * len(firm)
    err = np.abs(t - j).max(1)[firm]
    assert err.max() <= tol, f"{name}: {err.max()}"


def _argmax_firm(score, valid, gap=1e-5):
    """The largest score of each row beats the runner-up by ``gap``."""
    s = np.sort(np.where(valid, score, -np.inf), axis=1)
    with np.errstate(invalid="ignore"):
        return (s[:, -1] - s[:, -2]) > gap


@pytest.mark.parametrize("which", ["board", "flare"])
def test_board_flare_match_jax(scene, which):
    jc, tc = scene["jc"], scene["tc"]
    if which == "board":
        fj, okj = jlrf.board_lrf(jc, R)
        ft, okt = tlrf.board_lrf(tc, R)
    else:
        fj, okj = jlrf.flare_lrf(jc, R)
        ft, okt = tlrf.flare_lrf(tc, R)
    fj, okj, ft, okt = np.asarray(fj), np.asarray(okj), ft.numpy(), okt.numpy()
    np.testing.assert_array_equal(okt, okj)
    # firm: the plane fit's eigenvalues apart and the argmax clear, both
    # from the JAX side's own frames
    xyz, nrm, idx, valid = scene["xyz"], scene["nrm"], scene["idx"], scene["valid"]
    d = xyz[idx] - xyz[:, None, :]
    _, cov, _ = (np.asarray(v) for v in jgeo.mean_and_covariance(jnp.asarray(xyz[idx]),
                                                                  jnp.asarray(valid)))
    lam = np.linalg.eigvalsh(cov.astype(np.float64))
    z = fj[:, 2, :].astype(np.float64)
    if which == "board":
        score = 1.0 - np.einsum("nki,ni->nk", nrm[idx], z)
        sv = valid
    else:
        signed = np.einsum("nki,ni->nk", d, z)
        ring = valid & (np.linalg.norm(d, axis=-1) >= 0.85 * R * 0.5)
        sv = np.where(ring.any(1)[:, None], ring, valid)
        score = signed
    firm = okj & F.isolated(lam, 0.05) & _argmax_firm(score, sv)
    _check(which, ft, fj, firm, 1e-4)


def test_board_surface_matches_jax(scene):
    """Frames at every 5th point from the whole cloud's neighbourhoods."""
    from pcl_tpu.core.cloud import Cloud as JCloud
    from pcl_tpu_torch.core.cloud import Cloud as TCloud

    sel = np.arange(0, 1500, 5)
    q = scene["xyz"][sel]
    fj, okj = jlrf.board_lrf(JCloud(xyz=jnp.asarray(q), mask=jnp.ones(len(q), bool)), R,
                             surface=scene["jc"])
    ft, okt = tlrf.board_lrf(TCloud(xyz=torch.from_numpy(q), mask=torch.ones(len(q),
                                                                             dtype=torch.bool)),
                             R, surface=scene["tc"])
    fj, okj = np.asarray(fj), np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    # the surface rows equal the self-query rows of the same points
    fs, oks = tlrf.board_lrf(scene["tc"], R)
    agree = oks.numpy()[sel]
    assert np.abs(ft.numpy()[agree] - fs.numpy()[sel][agree]).max() <= 1e-6
    diff = np.abs(ft.numpy() - fj).max(axis=(1, 2))
    assert np.mean(diff[okj] <= 1e-4) >= 0.95


def _sc_firm(frames, scene, min_r):
    """The shape-context cuts (``float64_cuts.sc_firm``) on the scene's lists."""
    return F.sc_firm(frames, scene["xyz"], scene["idx"], scene["valid"], scene["d2"], R, min_r,
                     eps=EPS)


def test_3dsc_core_matches_jax_on_its_draw(scene):
    """3DSC through its core, fed the JAX package's own normal draw (C17)."""
    key = jax.random.PRNGKey(7)
    j = np.asarray(jsc.estimate_3dsc(scene["jc"], R, key=key))
    rnd = np.array(jax.random.normal(key, (1536, 3)))
    t = tsc.estimate_3dsc_core(scene["tc"], R, torch.from_numpy(rnd)).numpy()
    z = scene["nrm"].astype(np.float64)
    x = rnd - np.sum(rnd * z, -1, keepdims=True) * z
    x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    frames = np.stack([x, np.cross(z, x), z], -2)
    firm = _sc_firm(frames, scene, 0.1 * R) & scene["mask"]
    _check("3DSC", t, j, firm, 1e-5)
    # the sampler feeds the core its draw
    g = torch.Generator().manual_seed(3)
    drawn = tsc.draw_3dsc_axes(1536, gen=torch.Generator().manual_seed(3))
    assert torch.equal(tsc.estimate_3dsc(scene["tc"], R, gen=g),
                       tsc.estimate_3dsc_core(scene["tc"], R, drawn))


def test_usc_matches_jax(scene):
    hj, fj = (np.asarray(v) for v in jsc.estimate_usc(scene["jc"], R))
    ht, ft = (v.numpy() for v in tsc.estimate_usc(scene["tc"], R))
    frames64, firm = F.hard_lrf64(scene["xyz"], scene["idx"],
                                  scene["valid"] & (scene["d2"] > 1e-12), R)
    firm &= scene["mask"]
    _check("USC frames", ft, fj, firm, 1e-4)
    _check("USC", ht, hj, firm & _sc_firm(frames64, scene, 0.1 * R), 1e-5)


def test_rops_matches_jax(scene):
    dj, fj = (np.asarray(v) for v in jrops.estimate_rops(scene["jc"], R))
    dt, ft = (v.numpy() for v in trops.estimate_rops(scene["tc"], R))
    frames64, firm = F.hard_lrf64(scene["xyz"], scene["idx"], scene["valid"], R)
    firm &= scene["mask"]
    _check("RoPS frames", ft, fj, firm, 1e-4)
    scale = max(float(np.abs(dj).max()), 1.0)
    cuts = F.rops_firm(frames64, scene["xyz"], scene["idx"], scene["valid"], R, eps=EPS)
    _check("RoPS", dt, dj, firm & cuts, 1e-5 * scale)


def _patch(n=24, seed=2):
    """A triangulated n x n height field (two triangles a grid cell)."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:n, 0:n].astype(np.float64) / (n - 1)
    z = 0.15 * np.sin(3 * u) * np.cos(2 * v)
    xyz = np.stack([u + rng.normal(scale=2e-3, size=u.shape),
                    v + rng.normal(scale=2e-3, size=u.shape), z], -1).reshape(-1, 3)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = i[:-1, :-1].ravel(), i[:-1, 1:].ravel(), i[1:, :-1].ravel(), i[1:, 1:].ravel()
    tri = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])
    return xyz.astype(np.float32), tri.astype(np.int64)


def _mesh_firm(xyz, kidx, lrf, r, n_rotations=3, n_bins=5):
    """Keypoints of mesh RoPS with no support point within EPS (radii or
    bins) of the support radius or of an edge of a projection's bins, in
    float64 in the JAX package's frames."""
    x = xyz.astype(np.float64)
    rel = x[None, :, :] - x[kidx][:, None, :]
    d = np.linalg.norm(rel, axis=-1)
    inside = d <= r
    firm = ~np.any(np.abs(d - r) < EPS * r, axis=1)
    pts = np.einsum("kij,kpj->kpi", lrf.astype(np.float64), rel)
    step = 90.0 / (n_rotations + 1)
    for axis in range(3):
        for i_rot in range(1, n_rotations + 1):
            Rm = np.asarray(trops._rot(axis, torch.tensor(step * i_rot * np.pi / 180.0,
                                                          dtype=torch.float64)))
            p = np.einsum("ij,kpj->kpi", Rm, pts)
            for c in range(3):
                u = p[..., c]
                lo = np.min(np.where(inside, u, np.inf), 1)[:, None]
                hi = np.max(np.where(inside, u, -np.inf), 1)[:, None]
                pos = (u - lo) / np.maximum(hi - lo, 1e-12) * n_bins
                firm &= ~np.any(inside & F.near_grid(pos, EPS) & (pos > EPS)
                                & (pos < n_bins - EPS), axis=1)
    return firm


def test_rops_mesh_matches_jax():
    """Mesh RoPS on a triangulated patch; one chunk smaller than the
    keypoints so the port's chunks are covered; caps cut on purpose for the
    overflow flag."""
    xyz, tri = _patch()
    kidx = np.arange(30, 546, 7)
    fj, lj, oj = (np.asarray(v) for v in jrops.estimate_rops_mesh(
        xyz, tri, kidx, 0.2, cap_pts=256, cap_tri=512, chunk=32))
    ft, lt, ot = (v.numpy() for v in trops.estimate_rops_mesh(
        xyz, tri, kidx, 0.2, cap_pts=256, cap_tri=512, chunk=32, device="cpu"))
    np.testing.assert_array_equal(ot, oj)
    frame_ok = np.abs(lt - lj).max(axis=(1, 2)) <= 1e-4
    assert frame_ok.mean() >= 0.9
    firm = frame_ok & ~oj & _mesh_firm(xyz, kidx, lj, 0.2)
    _check("RoPS mesh", ft, fj, firm, 1e-5)
    np.testing.assert_allclose(np.abs(ft).sum(1), 1.0, atol=1e-5)
    # a cap that cuts the support is flagged on both
    _, _, oj2 = jrops.estimate_rops_mesh(xyz, tri, kidx[:8], 0.2, cap_pts=16, cap_tri=512)
    _, _, ot2 = trops.estimate_rops_mesh(xyz, tri, kidx[:8], 0.2, cap_pts=16, cap_tri=512,
                                         device="cpu")
    assert np.asarray(oj2).all() and ot2.all()


def test_spin_images_match_jax(scene):
    j = np.asarray(jlm.spin_images(scene["jc"], R))
    t = tlm.spin_images(scene["tc"], R).numpy()
    x = scene["xyz"].astype(np.float64)
    rel = x[scene["idx"]] - x[:, None, :]
    beta = np.einsum("nki,ni->nk", rel, scene["nrm"].astype(np.float64))
    alpha = np.sqrt(np.maximum((rel * rel).sum(-1) - beta * beta, 0))
    cut = F.near_grid(alpha / R * 8, EPS) | F.near_grid((beta / R + 1) * 8, EPS)
    # the point itself lies exactly on an edge in both packages
    firm = scene["mask"] & ~np.any(scene["valid"] & (scene["d2"] > 0) & cut, 1)
    _check("spin images", t, j, firm, 1e-6)


@pytest.mark.parametrize("kw", [{}, {"radial": True}, {"support_angle_cos": 0.5},
                                {"angular": True, "support_angle_cos": 0.5}],
                         ids=["rectangular", "radial", "support", "angular"])
def test_spin_images_reference_matches_jax(scene, kw):
    j = np.asarray(jlm.spin_images_reference(scene["jc"], R, **kw))
    t = tlm.spin_images_reference(scene["tc"], R, **kw).numpy()
    idx, d2, valid = (np.asarray(v) for v in jbf.knn(scene["jc"].xyz, scene["jc"].mask,
                                                     scene["jc"].xyz, 256))
    valid = valid & (d2 <= np.float32(R) ** 2) & scene["mask"][:, None]
    x = scene["xyz"].astype(np.float64)
    nrm = scene["nrm"].astype(np.float64)
    rel = x[idx] - x[:, None, :]
    dn = np.sqrt(np.maximum(d2.astype(np.float64), 0))
    cda = np.clip(np.einsum("nki,ni->nk", rel, nrm) / np.maximum(dn, 1e-30), -1, 1)
    cosbn = np.abs(np.einsum("ni,nki->nk", nrm, nrm[idx]))
    if kw.get("radial"):
        a_pos, b_pos = dn / (R / 8), np.arcsin(cda) / (np.pi / 16)
    else:
        bs = R / 8 / np.sqrt(2)
        a_pos, b_pos = dn * np.sqrt(np.maximum(1 - cda * cda, 0)) / bs, dn * cda / bs
    cut = F.near_grid(a_pos, EPS) | F.near_grid(b_pos, EPS) | (np.abs(cosbn - 0.5) < EPS)
    firm = scene["mask"] & ~np.any(valid & (d2 > 0) & cut, 1)
    _check(f"spin_images_reference {kw}", t, j, firm, 1e-3 if kw.get("angular") else 1e-5)


def test_principal_curvatures_match_jax(scene):
    pj = [np.asarray(v) for v in jlm.principal_curvatures(scene["jc"])]
    pt = [v.numpy() for v in tlm.principal_curvatures(scene["tc"])]
    scale = float(pj[0].max())
    for a, b in zip(pt[:2], pj[:2]):
        assert np.abs(a - b).max() <= 1e-5 * scale
    # the direction, with its sign, where pc1 is isolated
    firm = (pj[0] - pj[1]) > 1e-2 * scale
    _check("principal direction", np.abs(pt[2]), np.abs(pj[2]), firm, 1e-4, share=0.3)


def test_boundary_estimation_matches_jax(scene):
    j = np.asarray(jlm.boundary_estimation(scene["jc"], R))
    t = tlm.boundary_estimation(scene["tc"], R).numpy()
    assert j.sum() > 10 and (~j & scene["mask"]).sum() > 10
    np.testing.assert_array_equal(t, j)


def test_difference_of_normals_matches_jax(scene):
    j = np.asarray(jlm.difference_of_normals(scene["jc"]))
    t = tlm.difference_of_normals(scene["tc"]).numpy()
    # the two normals are eigenvectors: compared where both packages agree
    # to the normals' own tolerance (C9)
    close = np.abs(t - j) <= 1e-4
    assert close.mean() >= 0.98


def test_moments_match_jax(scene):
    mj = jlm.moment_of_inertia(scene["jc"])
    mt = tlm.moment_of_inertia(scene["tc"])
    assert type(mt).__name__ == "MomentsResult" and mt._fields == mj._fields
    for name in mj._fields:
        a, b = np.asarray(getattr(mj, name), np.float64), getattr(mt, name).numpy()
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(a).max(), 1.0), name
    ij = np.asarray(jlm.moment_invariants(scene["jc"], R))
    it = tlm.moment_invariants(scene["tc"], R).numpy()
    assert np.all(np.abs(it - ij) <= 1e-5 * np.abs(ij).max(0))


def test_rsd_grsd_match_jax(scene):
    rj = [np.asarray(v) for v in jrsd.estimate_rsd(scene["jc"], R)]
    rt = [v.numpy() for v in trsd.estimate_rsd(scene["tc"], R)]
    for a, b in zip(rt, rj):
        assert np.abs(a - b).max() <= 1e-5
    gj = np.asarray(jrsd.estimate_grsd(scene["jc"], R))
    gt = trsd.estimate_grsd(scene["tc"], R).numpy()
    assert gt.shape == (trsd.GRSD_BINS,) == (jrsd.GRSD_BINS,)
    np.testing.assert_allclose(gt, gj, atol=1e-6)


@pytest.mark.parametrize("distance", ["l1", "l2", "chisq"])
def test_feature_persistence_matches_jax(scene, distance):
    """Both packages persist the same descriptors (spin images at three
    radii, the JAX package's, handed to each as its own array type); the
    distances agree to 1e-5 of their scale and the masks where no distance
    lies within that of its threshold."""
    scales = (0.25, 0.3, 0.35)
    feats = {s: np.array(jlm.spin_images(scene["jc"], s)) for s in scales}
    pj, dj = (np.asarray(v) for v in jpers.feature_persistence(
        lambda s: jnp.asarray(feats[s]), scales, scene["jc"].mask, distance=distance))
    pt, dt = tpers.feature_persistence(lambda s: torch.from_numpy(feats[s]), scales,
                                       scene["tc"].mask, distance=distance)
    pt, dt = pt.numpy(), dt.numpy()
    tol = 1e-5 * np.abs(dj).max()
    assert np.abs(dt - dj).max() <= tol
    w = scene["mask"]
    thr = np.array([d[w].mean() + d[w].std() for d in dj.astype(np.float64)])
    firm = np.all(np.abs(dj - thr[:, None]) > 10 * tol, axis=0)
    assert pj.sum() > 0 and firm.mean() > 0.9
    np.testing.assert_array_equal(pt[firm], pj[firm])
    with pytest.raises(ValueError, match="unknown distance"):
        tpers.feature_persistence(lambda s: torch.from_numpy(feats[s]), scales,
                                  scene["tc"].mask, distance="cosine")


def test_features_require_normals(scene):
    bare = scene["tc"].without_attrs("normal")
    for fn in (lambda c: tlrf.board_lrf(c, R), lambda c: tsc.estimate_3dsc(c, R),
               lambda c: tlm.spin_images(c, R), lambda c: tlm.principal_curvatures(c),
               lambda c: tlm.boundary_estimation(c, R), lambda c: trsd.estimate_rsd(c, R),
               lambda c: tlm.spin_images_reference(c, R)):
        with pytest.raises(ValueError, match="normal"):
            fn(bare)
    assert tfeat.board_lrf is tlrf.board_lrf
