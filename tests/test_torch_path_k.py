"""The slice as a whole against the JAX package on the CPU: path K's chain
at a quarter of a scan (``chip_smoke.py``'s street and path E's cut,
30,000-point scans, ground removed, 0.3 m voxels, normals from the port
handed to both packages): Harris 3-D and ISS keypoints over 1.5 m, SHOT at
their union with the voxels as search surface, ``feature_knn`` of scan 1's
descriptors into scan 0's, and the prerejective core on the JAX package's
own draws (ROADMAP C17).

- Keypoints (at path K's threshold: on a plane the response is 0 up to
  rounding) agree wherever the response clears the threshold and every
  neighbour's response by 1e-6 of the largest (``test_torch_keypoints``);
  ISS keypoints differ on at most 1% (at this density nearly every decision
  has a neighbour within ``test_torch_iss``'s margin; C9). The chain then
  runs on the JAX package's keypoints on both sides.
- SHOT rows agree to 2e-5 where ``torch_feature_scenes.shot_firm`` finds
  every decision firm (``test_torch_shot``), and at most 5% of all rows
  differ by more (measured: none, 1.3e-6 at most).
- Feature kNN indices agree except where two listed distances lie within
  1e-4 (unit descriptors: the matrix-product distance over 352 bins rounds
  at ~2e-5).
- Prerejective hypotheses (the JAX side rebuilt from its own pieces, as
  ``test_torch_ia`` does): rotations to 1e-4 and translations to 1e-4 of
  (1 m + their length) where Horn's problem is well posed (its top two
  eigenvalues 5% apart), inlier fractions to 4 of the 128 subset points
  (``test_torch_ia``'s tolerances: C1 moves points across the gate).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
import torch_feature_scenes as S
from pcl_tpu.core import geometry as jgeom
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.features import shot as jshot
from pcl_tpu.keypoints import harris as jh
from pcl_tpu.keypoints.iss import iss3d_keypoints as jiss
from pcl_tpu.registration import ia as jia
from pcl_tpu.search import bruteforce as jbf
from test_torch_ia import _draws, _horn_gap
from test_torch_keypoints import _nms_firm

from pcl_tpu_torch.core.cloud import Cloud, make_cloud
from pcl_tpu_torch.features import shot as tshot
from pcl_tpu_torch.keypoints import harris3d_keypoints, iss3d_keypoints
from pcl_tpu_torch.registration import ia as tia

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
cs = importlib.import_module("chip_smoke")

QUARTER = 30_000
RADIUS = 1.5


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def pair(monkeypatch_module):
    from pcl_tpu_torch import features, filters, sac, segmentation

    monkeypatch_module.setitem(cs.SEQUENCE_KW, "max_points", QUARTER)
    street = cs.make_street(n=cs.SCENE_POINTS // 4)
    rng = np.random.default_rng(cs.E_SEED)
    out = []
    for pose in (np.eye(4), cs.pose_matrix(*cs.E_POSE)):
        c = make_cloud(cs.scan_at(street, pose, rng), device="cpu")
        seg = segmentation.sac_segmentation(c, sac.PlaneModel(), cs.E_GROUND_THRESHOLD)
        v = cs.live_rows(filters.voxel_downsample(c.with_mask(~seg.inliers), cs.E_LEAF))
        out.append(features.estimate_normals(v, k=cs.NORMAL_K))
    return out[1], out[0]


def _j(c: Cloud) -> JCloud:
    return JCloud(xyz=jnp.asarray(c.xyz.numpy()), mask=jnp.asarray(c.mask.numpy()),
                  attrs={k: jnp.asarray(v.numpy()) for k, v in c.attrs.items()})


def _keypoints_and_shot(vox: Cloud):
    """Both packages' Harris and ISS keypoints of ``vox`` (held to each
    other), then SHOT at the JAX package's union of the two on both:
    ``(jax rows, port rows, port keypoint cloud, JAX keypoint cloud, firm
    rows)``."""
    jv = _j(vox)
    thr = cs.K_HARRIS_THRESHOLD
    mj, rj = (np.asarray(v) for v in jh.harris3d_keypoints(jv, RADIUS, threshold=thr, k=48))
    mt, rt = (v.numpy() for v in harris3d_keypoints(vox, RADIUS, threshold=thr, k=48))
    idx, _, valid, _ = (np.asarray(v) for v in jbf.radius(jv.xyz, jv.mask, jv.xyz, RADIUS,
                                                          cap=48))
    tol = np.full(len(rj), 1e-6 * np.abs(rj).max())
    assert np.all(np.abs(rt - rj) <= tol)
    firm = _nms_firm(rj, idx, valid & np.asarray(jv.mask)[:, None], np.asarray(jv.mask), thr,
                     tol)
    assert firm.mean() > 0.9 and mj.sum() >= 3
    np.testing.assert_array_equal(mt[firm], mj[firm])
    # ISS as path H takes it: density weights, non-max over half the radius
    ij = np.asarray(jiss(jv, RADIUS, RADIUS / 2, density_weights=True)[0])
    it = iss3d_keypoints(vox, RADIUS, RADIUS / 2, density_weights=True)[0].numpy()
    # at this density nearly every ISS decision has a neighbour within
    # ``test_torch_iss``'s margin, so the masks are held to differ on at most
    # 1% of the keypoints (they agree exactly on this pair)
    assert ij.sum() >= 50 and (it != ij).sum() <= 0.01 * ij.sum()
    sel = np.nonzero(mj | ij)[0]
    kx = np.asarray(jv.xyz)[sel]
    jq = JCloud(xyz=jnp.asarray(kx), mask=jnp.ones(len(sel), bool))
    tq = Cloud(xyz=torch.from_numpy(kx), mask=torch.ones(len(sel), dtype=torch.bool))
    fj = np.asarray(jshot.estimate_shot_interpolated(jq, RADIUS, surface=jv))
    ft = tshot.estimate_shot_interpolated(tq, RADIUS, surface=vox).numpy()
    kidx, kd2, kvalid = (np.asarray(v) for v in jbf.knn(jv.xyz, jv.mask, jq.xyz, 128))
    sfirm = F.shot_firm(np.asarray(jv.xyz), np.asarray(jv.attrs["normal"]), kx, kidx, kd2,
                        kvalid, RADIUS)
    return fj, ft, tq, jq, sfirm


def _close_transforms(a, b):
    """Rotations to 1e-4, translations to 1e-4 of (1 m + their length): a
    wrong match sends a hypothesis tens of metres away, and the rotation's
    rounding grows with that lever."""
    np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], atol=1e-4)
    tol = 1e-4 * (1.0 + np.linalg.norm(b[:, :3, 3], axis=1))
    assert np.all(np.abs(a[:, :3, 3] - b[:, :3, 3]).max(1) <= tol)


def test_slice_chain_matches_jax(pair):
    src, tgt = pair
    fs_j, fs_t, s_t, s_j, s_firm = _keypoints_and_shot(src)
    ft_j, ft_t, t_t, t_j, t_firm = _keypoints_and_shot(tgt)
    for fj, ft, firm in ((fs_j, fs_t, s_firm), (ft_j, ft_t, t_firm)):
        print(S.count_line("path K SHOT", firm))
        # with ~100 neighbours over 1.5 m most rows have one near some cut;
        # of those, at most 5% may differ beyond the tolerance
        err = np.abs(ft - fj).max(1)
        assert firm.mean() >= 0.2 and err[firm].max() <= 2e-5
        assert (err > 2e-5).sum() <= 0.05 * len(err)

    # feature kNN on the JAX descriptors, both packages
    k_corr = 5
    want = np.asarray(jia.feature_knn(jnp.asarray(fs_j), s_j.mask, jnp.asarray(ft_j), t_j.mask,
                                      k_corr))
    got = tia.feature_knn(torch.from_numpy(fs_j.copy()), s_t.mask, torch.from_numpy(ft_j.copy()), t_t.mask,
                          k_corr).numpy()
    a, b = fs_j.astype(np.float64), ft_j.astype(np.float64)
    d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    dl = np.take_along_axis(d, want.astype(np.int64), axis=1)
    gap = np.abs(np.diff(dl, axis=1)) <= 1e-4
    near = np.zeros_like(gap, shape=want.shape)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert (~near).mean() > 0.8
    np.testing.assert_array_equal(got[~near], want[~near])

    # the prerejective core on the JAX draws, path E's gate; the JAX side's
    # hypotheses from its own pieces, as ``test_torch_ia`` rebuilds them
    key = jax.random.PRNGKey(cs.E_SEED)
    n_hyp, n_eval = 2048, 128
    sidx, pick, sub = _draws(key, n_hyp, 3, k_corr, n_eval, s_j.mask)
    tidx = np.take_along_axis(want[np.asarray(sidx)], np.asarray(pick)[..., None], -1)[..., 0]
    src_s, tgt_s = np.asarray(s_j.xyz)[np.asarray(sidx)], np.asarray(t_j.xyz)[tidx]
    Ts_j = np.asarray(jgeom.umeyama(jnp.asarray(src_s), jnp.asarray(tgt_s),
                                    jnp.ones((n_hyp, 3), jnp.float32)))
    d2_j = np.asarray(jia._batched_nn_d2(jnp.asarray(Ts_j), s_j.xyz[sub], t_j.xyz, t_j.mask))
    well = _horn_gap(src_s, tgt_s) > 0.05
    to = [torch.from_numpy(np.array(a)) for a in (want, sidx, pick, sub)]
    Ts, score = tia.prerejective_scores(s_t, t_t, *to, inlier_threshold=cs.E_INLIER)
    # every hypothesis has a transform; few pass the polygon test on SHOT's
    # matches at this size (2 of 2048 here), and those are scored
    ok = np.isfinite(score.numpy())
    fin = np.isfinite(Ts_j).all(axis=(1, 2))
    assert ok.sum() >= 1 and (well & fin).sum() >= 100
    _close_transforms(Ts.numpy()[well & fin], Ts_j[well & fin])
    score_j = (d2_j <= np.float32(cs.E_INLIER ** 2)).mean(1)
    np.testing.assert_allclose(score.numpy()[ok & well], score_j[ok & well], atol=4 / n_eval)
    got_r = tia.prerejective_core(s_t, t_t, *to, inlier_threshold=cs.E_INLIER)
    best_j = np.argmax(np.where(ok, score_j, -np.inf))
    top2 = np.sort(np.where(ok, score_j, -np.inf))[-2:]
    if top2[1] - top2[0] > 8 / n_eval and well[best_j]:
        _close_transforms(got_r.transform.numpy()[None], Ts_j[best_j][None])
    assert bool(got_r.valid)
    assert abs(float(got_r.error) - (1.0 - score_j[best_j])) <= 4 / n_eval
