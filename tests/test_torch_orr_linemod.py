"""Parity of the port's ObjRecRANSAC pieces, trimmed ICP, distance and mask
maps, LINEMOD and its template files with the JAX package on the CPU.

Tolerances:
- Trimmed ICP: pose to 1e-4 and MSE to 8 ulp of the largest ``|q|^2 +
  |t|^2`` (C1 and C10: the iteration counts are not compared).
- ObjRecRANSAC's cores run on the JAX package's own draws (C17): every
  hypothesis whose best model pair beats the runner-up by more than 1e-4 in
  float64 feature space gives the same transform to 1e-4; support differs
  by at most the model points whose 1-NN lies within 8 ulp of ``|q|^2 +
  |t|^2`` of the inlier distance (C1), divided by the model's size.
- Distance maps, masks, spread maps, score maps and detections: equal.
- The quantised LINEMOD maps: equal where the float64 orientation lies more
  than 1e-5 rad from a bin edge (``atan2``'s last bit, C78): at least 95%
  of the quantised pixels.
- Pair-feature histograms: equal once the pairs with an angle within 1e-5
  of a bin edge are left out of both.
- Template files: byte-equal, and each package reads the other's.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.recognition import linemod as jlm
from pcl_tpu.recognition import linemod_io as jio
from pcl_tpu.recognition import orr as jorr

from pcl_tpu_torch import interop
from pcl_tpu_torch.core.cloud import make_cloud as tmake
from pcl_tpu_torch.recognition import linemod as tlm
from pcl_tpu_torch.recognition import linemod_io as tio
from pcl_tpu_torch.recognition import orr as torr

ULP = 2.0 ** -23


def _t(x):
    return torch.from_numpy(np.array(x))


def _a(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _clouds(xyz, nrm=None):
    attrs_j = {} if nrm is None else {"normal": jnp.asarray(nrm)}
    attrs_t = {} if nrm is None else {"normal": nrm}
    return (jmake(jnp.asarray(xyz), attrs=attrs_j), tmake(xyz, attrs=attrs_t, device="cpu"))


@pytest.mark.parametrize("trim", [0.5, 0.8])
def test_trimmed_icp_matches_jax(trim):
    rng = np.random.default_rng(2)
    tgt = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    src = np.concatenate([tgt[:250] + np.float32([0.05, -0.02, 0.03]),
                          rng.uniform(5, 6, (150, 3)).astype(np.float32)])
    (js, ts), (jt, tt) = _clouds(src), _clouds(tgt)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.01, 0.0, -0.01]
    j = jorr.trimmed_icp(js, jt, trim_fraction=trim, max_iterations=40, init=jnp.asarray(init))
    t = torr.trimmed_icp(ts, tt, trim_fraction=trim, max_iterations=40, init=_t(init))
    np.testing.assert_allclose(_a(t.transform), np.asarray(j.transform), atol=1e-4)
    # C1: the JAX package's CPU distances are the matmul identity's
    scale = 8 * ULP * float((src ** 2).sum(1).max() + (tgt ** 2).sum(1).max())
    assert abs(float(t.mse) - float(j.mse)) <= scale
    assert t.iterations >= 2


def _bumpy(n, seed):
    """A bumpy closed surface with outward normals: no two model pairs
    share their PPF features, so the best match is decided by the data."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = 0.5 + 0.08 * np.sin(3 * v[:, 0]) * np.cos(2 * v[:, 1]) + 0.05 * v[:, 2] ** 2
    return (v * r[:, None]).astype(np.float32), v.astype(np.float32)


@pytest.fixture(scope="module")
def orr_scene():
    mxyz, mnrm = _bumpy(300, 0)
    R = Rotation.from_rotvec([0.1, 0.4, -0.2]).as_matrix().astype(np.float32)
    t = np.float32([1.0, -0.5, 0.3])
    sxyz = (mxyz @ R.T + t).astype(np.float32)
    snrm = (mnrm @ R.T).astype(np.float32)
    extra = np.random.default_rng(1).uniform(-1, 2, (100, 3)).astype(np.float32)
    sxyz = np.concatenate([sxyz, extra])
    snrm = np.concatenate([snrm, np.tile(np.float32([0, 0, 1]), (100, 1))])
    return mxyz, mnrm, sxyz, snrm, R, t


def _jax_orr_draws(key, smask, sxyz, n_m, pair_dist, dist_tol, H):
    """The draws of the JAX package's ``_orr_hypotheses`` (its own calls,
    traced the same way)."""
    @jax.jit
    def draw(key, sxyz, smask):
        k1, k2 = jax.random.split(key)
        i1 = jax.random.categorical(k1, jnp.log(smask.astype(jnp.float32) + 1e-9), shape=(H,))
        d = jnp.linalg.norm(sxyz[None, :, :] - sxyz[i1][:, None, :], axis=-1)
        ok = smask[None, :] & (jnp.abs(d - pair_dist) < dist_tol)
        i2 = jax.random.categorical(k2, jnp.where(ok, 0.0, -1e9), axis=-1)
        mp1 = jax.random.randint(jax.random.split(key, 3)[2], (512,), 0, n_m)
        return i1, i2, mp1
    return [torch.from_numpy(np.array(x)).long() for x in draw(key, jnp.asarray(sxyz),
                                                              jnp.asarray(smask))]


def _ppf64(p1, n1, p2, n2):
    dv = p2 - p1
    dn = np.linalg.norm(dv, axis=-1, keepdims=True) + 1e-12
    u = dv / dn

    def ac(x):
        return np.arccos(np.clip(x, -1, 1))
    return np.stack([dn[..., 0], ac((n1 * u).sum(-1)), ac((n2 * u).sum(-1)),
                     ac((n1 * n2).sum(-1))], -1)


def _firm_matches(draws, mxyz, mnrm, sxyz, snrm, pair_dist, dist_tol, eps=1e-4):
    i1, i2, mp1 = (_a(d) for d in draws)
    m = mxyz.astype(np.float64)
    s = sxyz.astype(np.float64)
    dmm = np.linalg.norm(m[None] - m[mp1][:, None], axis=-1)
    okm = np.abs(dmm - pair_dist) < dist_tol
    mp2 = okm.argmax(1)
    mp_ok = okm[np.arange(len(mp1)), mp2]
    sf = _ppf64(s[i1], snrm[i1], s[i2], snrm[i2])
    mf = _ppf64(m[mp1], mnrm[mp1], m[mp2], mnrm[mp2])
    fd = np.where(mp_ok[None], ((sf[:, None] - mf[None]) ** 2).sum(-1), np.inf)
    # the runner-up among the other model pairs (``randint`` draws a start
    # more than once, and a repeated pair ties with itself in both packages)
    best = fd.argmin(1)
    same = (mp1[None, :] == mp1[best][:, None]) & (mp2[None, :] == mp2[best][:, None])
    runner = np.where(same, np.inf, fd).min(1)
    return runner - fd[np.arange(len(i1)), best] > eps


def _near_threshold(T, mxyz, sxyz, r):
    """Per hypothesis, the model points whose float64 1-NN distance lies
    within 8 ulp of ``|q|^2 + |t|^2`` of ``r^2``."""
    out = []
    s = sxyz.astype(np.float64)
    for Ti in T.astype(np.float64):
        q = mxyz @ Ti[:3, :3].T + Ti[:3, 3]
        d2 = ((q[:, None] - s[None]) ** 2).sum(-1)
        j = d2.argmin(1)
        scale = (q ** 2).sum(1) + (s[j] ** 2).sum(1)
        out.append(int((np.abs(d2[np.arange(len(q)), j] - r * r) <= 8 * ULP * scale).sum()))
    return np.array(out)


def test_orr_hypotheses_and_support_match_jax_on_its_draws(orr_scene):
    mxyz, mnrm, sxyz, snrm, R, t = orr_scene
    smask = np.ones(len(sxyz), bool)
    mmask = np.ones(len(mxyz), bool)
    pair_dist, dist_tol, H = 0.6, 0.08, 64
    key = jax.random.PRNGKey(3)
    jT = np.asarray(jorr._orr_hypotheses(
        key, jnp.asarray(sxyz), jnp.asarray(smask), jnp.asarray(snrm), jnp.asarray(mxyz),
        jnp.asarray(mmask), jnp.asarray(mnrm), jnp.float32(pair_dist), jnp.float32(dist_tol), H))
    draws = _jax_orr_draws(key, smask, sxyz, len(mxyz), pair_dist, dist_tol, H)
    tT = _a(torr._orr_hypotheses(*draws, _t(sxyz), _t(smask), _t(snrm), _t(mxyz), _t(mmask),
                                 _t(mnrm), pair_dist, dist_tol))
    firm = _firm_matches(draws, mxyz, mnrm, sxyz, snrm, pair_dist, dist_tol)
    assert firm.mean() > 0.8
    np.testing.assert_allclose(tT[firm], jT[firm], atol=1e-4)
    js = np.asarray(jorr._orr_support(jnp.asarray(jT), jnp.asarray(mxyz), jnp.asarray(mmask),
                                      jnp.asarray(sxyz), jnp.asarray(smask), jnp.float32(0.05)))
    ts = _a(torr._orr_support(_t(jT), _t(mxyz), _t(mmask), _t(sxyz), _t(smask), 0.05))
    near = _near_threshold(jT, mxyz, sxyz, 0.05)
    assert (np.abs(ts - js) * len(mxyz) <= near + 1e-3).all()


def test_obj_rec_ransac_matches_jax_on_its_draws(orr_scene):
    mxyz, mnrm, sxyz, snrm, R, t = orr_scene
    jm, tm = _clouds(mxyz, mnrm)
    js, ts = _clouds(sxyz, snrm)
    kw = dict(pair_dist=0.6, n_hypotheses=64, dist_tol=0.08, inlier_dist=0.05)
    jT, jsup = jorr.obj_rec_ransac(jm, js, seed=1, **kw)
    draws = _jax_orr_draws(jax.random.PRNGKey(1), np.ones(len(sxyz), bool), sxyz, len(mxyz),
                           0.6, 0.08, 64)
    tT, tsup = torr.obj_rec_ransac(tm, ts, draws=draws, **kw)
    np.testing.assert_allclose(tT, jT, atol=1e-4)
    assert abs(tsup - jsup) <= 1.0 / len(mxyz)
    # the sampler's own draws find the model
    sT, ssup = torr.obj_rec_ransac(tm, ts, seed=1, **kw)
    np.testing.assert_allclose(sT[:3, :3], R, atol=1e-3)
    np.testing.assert_allclose(sT[:3, 3], t, atol=1e-3)
    assert ssup > 0.95


def _jax_pair_draws(cloud, pair_dist, n, dist_tol, seed):
    """The JAX package's ``sample_oriented_point_pairs`` draws, redone with
    its own calls."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    xyz, mask = cloud.xyz, cloud.mask
    i1 = jax.random.categorical(k1, jnp.log(mask.astype(jnp.float32) + 1e-9), shape=(n,))
    d = jnp.linalg.norm(xyz[None, :, :] - xyz[i1][:, None, :], axis=-1)
    ok = mask[None, :] & (jnp.abs(d - pair_dist) < dist_tol)
    i2 = jax.random.categorical(k2, jnp.where(ok, 0.0, -1e9), axis=-1)
    return torch.from_numpy(np.array(i1)), torch.from_numpy(np.array(i2))


@pytest.mark.parametrize("pair_dist", [0.3, 0.6, 5.0], ids=["short", "long", "none"])
def test_oriented_pairs_and_hash_table_match_jax_on_its_draws(orr_scene, pair_dist):
    mxyz, mnrm, *_ = orr_scene
    jc, tc = _clouds(mxyz, mnrm)
    ji1, ji2, jv = jorr.sample_oriented_point_pairs(jc, pair_dist, 200, 0.05, seed=4)
    draws = _jax_pair_draws(jc, pair_dist, 200, 0.05, 4)
    ti1, ti2, tv = torr.sample_oriented_point_pairs(tc, pair_dist, 200, 0.05, draws=draws)
    np.testing.assert_array_equal(_a(ti1), np.asarray(ji1))
    np.testing.assert_array_equal(_a(ti2), np.asarray(ji2))
    np.testing.assert_array_equal(_a(tv), np.asarray(jv))
    jh, jn = jorr.pair_feature_hash_table(jc, pair_dist, 200, 0.05, 8, seed=4)
    th, tn = torr.pair_feature_hash_table(tc, pair_dist, 200, 0.05, 8, draws=draws)
    assert tn == jn == int(np.asarray(jv).sum())
    # the same histogram once pairs within 1e-5 of a bin edge are left out
    i1, i2, v = np.asarray(ji1), np.asarray(ji2), np.asarray(jv)
    m = mxyz.astype(np.float64)
    u = m[i2] - m[i1]
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
    ang = np.stack([np.arccos(np.clip((mnrm[i1] * u).sum(1), -1, 1)),
                    np.arccos(np.clip((mnrm[i2] * u).sum(1), -1, 1)),
                    np.arccos(np.clip((mnrm[i1] * mnrm[i2]).sum(1), -1, 1))], 1) / np.pi * 8
    edge = (np.abs(ang - np.round(ang)) < 1e-5).any(1) & v
    b = np.clip(ang.astype(np.int64), 0, 7)
    lin = (b[:, 0] * 8 + b[:, 1]) * 8 + b[:, 2]
    drop = np.bincount(lin[edge], minlength=512).reshape(8, 8, 8)
    np.testing.assert_array_equal(th - drop, jh - drop)
    if pair_dist == 5.0:
        assert tn == 0


def test_hash_table_bins_nan_at_zero():
    """A NaN normal gives NaN angles: the JAX package casts them to bin 0
    and clips (C71); so does the port."""
    xyz, nrm = _bumpy(60, 2)
    nrm = nrm.copy()
    nrm[:30] = np.nan
    jc, tc = _clouds(xyz, nrm)
    jh, jn = jorr.pair_feature_hash_table(jc, 0.3, 100, 0.05, 4, seed=1)
    draws = _jax_pair_draws(jc, 0.3, 100, 0.05, 1)
    th, tn = torr.pair_feature_hash_table(tc, 0.3, 100, 0.05, 4, draws=draws)
    assert tn == jn and th[0, 0, 0] > 0
    np.testing.assert_array_equal(th, jh)


@pytest.mark.parametrize("shape,density", [((20, 20), 0.1), ((17, 31), 0.02), ((9, 13), 0.0)],
                         ids=["square", "sparse", "empty"])
def test_distance_map_matches_jax(shape, density):
    m = np.random.default_rng(shape[0]).uniform(size=shape) < density
    if density:
        m[0, 0] = True
    a = _a(torr.distance_map(_t(m), rows=4))
    b = np.asarray(jorr.distance_map(jnp.asarray(m)))
    np.testing.assert_array_equal(a, b)


def test_masks_match_jax():
    rng = np.random.default_rng(6)
    m0, m1 = rng.uniform(size=(2, 15, 18)) < 0.6
    np.testing.assert_array_equal(_a(torr.mask_difference(_t(m0), _t(m1))),
                                  np.asarray(jorr.mask_difference(jnp.asarray(m0),
                                                                  jnp.asarray(m1))))
    for size in (2, 3, 5):
        np.testing.assert_array_equal(_a(torr.mask_erode(_t(m0), size)),
                                      np.asarray(jorr.mask_erode(jnp.asarray(m0), size)))


def _frame(seed, cx, cy, H=48, W=64):
    """An RGB-D frame (colours 0-255) with a box whose stripes run at 30
    degrees and whose face is tilted in both axes, so that no gradient is
    axis-aligned (those lie on bin edges)."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(20, 40, (H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    depth = (2.0 + 0.0023 * xx + 0.0011 * yy).astype(np.float32)
    ly, lx = np.mgrid[0:16, 0:16].astype(np.float64)
    stripes = 100.0 + 100.0 * np.sin(0.9 * (np.cos(0.52) * lx + np.sin(0.52) * ly))
    rgb[cy:cy + 16, cx:cx + 16] = (stripes[..., None] * np.float32([1.0, 0.7, 0.4]))
    depth[cy:cy + 16, cx:cx + 16] = 1.0 + 0.013 * lx + 0.021 * ly
    fx = 60.0
    u = (np.arange(W) - W / 2) / fx
    v = (np.arange(H) - H / 2) / fx
    xyz = np.stack([u[None, :] * depth, v[:, None] * depth, depth], -1).astype(np.float32)
    valid = np.ones((H, W), bool)
    valid[::11, ::7] = False
    return rgb, xyz, valid


def _edge_free(ang, eps=1e-5):
    """Pixels whose float64 orientation (``atan2 % pi``) lies more than
    ``eps`` rad from a bin edge."""
    a = np.mod(ang, np.pi)
    u = a / np.pi * 8
    return np.abs(u - np.round(u)) * np.pi / 8 > eps


def _color_angle64(rgb):
    img = rgb.astype(np.float64)
    gx = (np.roll(img, -1, 1) - np.roll(img, 1, 1)) * 0.5
    gy = (np.roll(img, -1, 0) - np.roll(img, 1, 0)) * 0.5
    c = ((gx * gx + gy * gy)).argmax(-1)
    pick = np.take_along_axis
    return np.arctan2(pick(gy, c[..., None], -1)[..., 0], pick(gx, c[..., None], -1)[..., 0])


def _normal_angle64(xyz):
    x = xyz.astype(np.float64)
    dx = (np.roll(x, -1, 1) - np.roll(x, 1, 1)) * 0.5
    dy = (np.roll(x, -1, 0) - np.roll(x, 1, 0)) * 0.5
    n = np.cross(dx, dy)
    return np.arctan2(n[..., 1], n[..., 0])


@pytest.fixture(scope="module")
def linemod_maps():
    out = {}
    for name, (cx, cy) in (("train", (10, 12)), ("test", (34, 24))):
        rgb, xyz, valid = _frame(len(name), cx, cy)
        jq = [np.asarray(q) for q in jlm.build_modality_maps(rgb, xyz, valid)]
        tq = [_a(q) for q in tlm.build_modality_maps(rgb, xyz, valid, device="cpu")]
        out[name] = (rgb, xyz, valid, jq, tq)
    return out


def test_quantized_maps_match_jax_off_bin_edges(linemod_maps):
    for rgb, xyz, valid, jq, tq in linemod_maps.values():
        firm = [_edge_free(_color_angle64(rgb)), _edge_free(_normal_angle64(xyz))]
        for a, b, f in zip(tq, jq, firm):
            assert (a >= 0).sum() > 50
            np.testing.assert_array_equal(a >= 0, b >= 0)
            np.testing.assert_array_equal(a[f], b[f])
            assert f[a >= 0].mean() > 0.95


@pytest.mark.parametrize("spread", [2, 3, 4, 7])
def test_spread_maps_match_jax(linemod_maps, spread):
    _, _, _, jq, _ = linemod_maps["test"]
    for q in jq:
        a = _a(tlm.spread_quantized_map(_t(q), spread))
        b = np.asarray(jlm.spread_quantized_map(jnp.asarray(q), spread))
        np.testing.assert_array_equal(a, b)


def test_templates_scores_and_detections_match_jax(linemod_maps, tmp_path):
    _, _, _, jq_train, _ = linemod_maps["train"]
    _, _, _, jq_test, _ = linemod_maps["test"]
    jt = jlm.extract_template(jq_train, (12, 10, 16, 16), n_features=40, seed=2)
    tt = tlm.extract_template([_t(q) for q in jq_train], (12, 10, 16, 16), n_features=40, seed=2)
    for f in ("offsets", "bins", "modality"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    smaps = [np.asarray(jlm.spread_quantized_map(jnp.asarray(q))) for q in jq_test]
    jscore = np.asarray(jlm._score_map(jnp.asarray(np.stack(smaps)), jnp.asarray(jt.offsets),
                                       jnp.asarray(jt.bins), jnp.asarray(jt.modality), 16, 16))
    tscore = _a(tlm._score_map(_t(np.stack(smaps)), tt.offsets, tt.bins, tt.modality, 16, 16))
    np.testing.assert_array_equal(tscore, jscore)
    jd = jlm.detect_templates(smaps, [jt], threshold=0.6)
    td = tlm.detect_templates(smaps, [tt], threshold=0.6, device="cpu")
    assert [(d.y, d.x, d.score, d.template_id) for d in td] == \
        [(d.y, d.x, d.score, d.template_id) for d in jd]
    assert td and abs(td[0].y - 24) <= 4 and abs(td[0].x - 34) <= 4
    # files: byte-equal, and each package reads the other's
    tmpl = interop.linemod_template_from_arrays(jt.offsets, jt.bins, jt.modality, jt.height,
                                                jt.width)
    pj, pt = str(tmp_path / "j.lmt"), str(tmp_path / "t.lmt")
    jio.save_templates(pj, [jt, jt])
    tio.save_templates(pt, [tmpl, tmpl])
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for back in (tio.load_templates(pj), jio.load_templates(pt)):
        assert len(back) == 2
        np.testing.assert_array_equal(back[1].offsets, jt.offsets)
        np.testing.assert_array_equal(back[1].bins, jt.bins)
        assert (back[0].height, back[0].width) == (16, 16)


def test_line_rgbd_detect_matches_jax(linemod_maps):
    rgb, xyz, valid, jq, _ = linemod_maps["train"]
    jt = jlm.extract_template(jq, (12, 10, 16, 16), n_features=40)
    trgb, txyz, tvalid, _, _ = linemod_maps["test"]
    jd = jlm.line_rgbd_detect(trgb, txyz, tvalid, [jt], threshold=0.6)
    td = tlm.line_rgbd_detect(trgb, txyz, tvalid, [jt], threshold=0.6, device="cpu")
    assert [(d.y, d.x, d.score) for d in td] == [(d.y, d.x, d.score) for d in jd]
    assert td
