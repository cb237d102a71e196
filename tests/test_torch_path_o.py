"""Path O's chain at 80 x 60 (``chip_smoke.O_SMALL``: two frames) on the
port beside the JAX package's calls (``tests/rehearse_path_o.jax_chain``), the
port fed the JAX package's draws (ROADMAP C17), then ``path_o_metrics`` on
the port's run.

Tolerances (the slice's unit tests' own):
- (a) HOG windows equal (numpy on both sides); the linear SVM's weights to
  1e-4 of the largest, the cross-validation accuracy and the file round
  trips equal, the Platt sigmoid to 1e-3.
- (b) The same detections in every frame: point counts equal, centroids and
  heights to 1e-5 (the voxel centroids round apart), scores to 1e-5
  relative; HOG features of each detection's window to 1e-5 on at least 90%
  of the blocks (a pixel within rounding of an orientation bin's edge can
  take the other bin, C78).
- (c) CRF posteriors to 1e-4 and labels equal wherever the top two differ
  by more than 1e-4; the CLIs' labels on 99% of the voxels (each package
  writes and reads its own PCD file).
- (d) Each tracker step from the JAX package's state, on its scene and its
  draws, against the JAX step with exact 1-NN distances (its Pallas kernel
  in interpret mode, C1): MAP poses to 1e-4, live slots equal, particles row
  by row to 1e-4 off the cumulative-weight edges (C17).
- (e) AGAST, BRISK and Trajkovic equal; KLT's points to 1e-3 px in every
  step and its status equal away from the border.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest

import chip_smoke as cs
import rehearse_path_o as rp


@pytest.fixture(scope="module")
def runs():
    O = cs.O_SMALL
    inp = cs.path_o_inputs(O)
    j, _, draws = rp.jax_chain(inp, O)
    p, _ = cs.path_o_chain(inp, O, "cpu", draws=draws)
    j["draws"] = draws
    return inp, O, j, p


def test_path_o_classifier_matches_jax(runs):
    _, _, j, p = runs
    w = j["svm"]["lin_w"]
    np.testing.assert_allclose(p["svm"]["lin_w"], w, atol=1e-4 * np.abs(w).max())
    assert p["svm"]["cv"] == j["svm"]["cv"]
    assert p["svm"]["rbf_train"] == j["svm"]["rbf_train"]
    np.testing.assert_allclose(p["svm"]["platt"], j["svm"]["platt"], rtol=1e-3, atol=1e-6)
    assert all(p["files"]) and all(j["files"])


def test_path_o_detections_match_jax(runs):
    _, _, j, p = runs
    np.testing.assert_allclose(p["ground"], j["ground"], atol=1e-5)
    assert [len(d) for d in p["dets"]] == [len(d) for d in j["dets"]]
    assert sum(len(d) for d in p["dets"]) >= 4
    for a, b in zip(p["dets"], j["dets"]):
        for (ca, ha, na, sa), (cb, hb, nb, sb) in zip(a, b):
            assert na == nb
            np.testing.assert_allclose(ca, cb, atol=1e-5)
            assert abs(ha - hb) <= 1e-5
            np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-5)
    for a, b in zip(p["hogs"], j["hogs"]):
        assert [h.shape for h in a] == [h.shape for h in b]
        for x, y in zip(a, b):
            assert np.mean(np.abs(x - y).max(1) <= 1e-5) >= 0.9


def test_path_o_crf_matches_jax(runs):
    _, _, j, p = runs
    np.testing.assert_array_equal(p["crf_truth"], j["crf_truth"])
    np.testing.assert_array_equal(p["crf_noisy"], j["crf_noisy"])
    for impl in ("permutohedral", "grid"):
        qa, qb = p["crf"][impl], j["crf"][impl]
        np.testing.assert_allclose(qa, qb, atol=1e-4)
        top2 = np.sort(qb, 1)[:, -2:]
        firm = top2[:, 1] - top2[:, 0] > 1e-4
        assert firm.mean() > 0.95
        np.testing.assert_array_equal(qa.argmax(1)[firm], qb.argmax(1)[firm])
    assert np.mean(p["crf_cli"] == j["crf_cli"]) >= 0.99


def _interpret_nn1(target, tmask, queries, **_):
    from pcl_tpu.ops import pallas_nn
    return pallas_nn.nn1_pallas(target, tmask, queries, qt=128, tt=256, interpret=True)


def test_path_o_trackers_match_jax_on_its_draws(runs):
    """Each step of both trackers from the JAX package's state before it, on
    its scene and its draws, against the JAX step run again with its 1-NN on
    the Pallas kernel in interpret mode (exact distances, as kernel B1's; the
    CPU path's matmul identity rounds by ~2^-22 (q^2 + t^2), 0.2% of sigma^2 at
    3 m, C1): the MAP pose to 1e-4, the live slots equal, and the particles
    row by row to 1e-4 but for rows whose sample point lies within 1e-4 of a
    cumulative-weight edge."""
    import jax
    import jax.numpy as jnp
    import torch

    from pcl_tpu.core.cloud import make_cloud as jmake
    from pcl_tpu.search import bruteforce as jbf
    from pcl_tpu.tracking import kld as jkld
    from pcl_tpu.tracking import particle_filter as jpf
    from pcl_tpu_torch import interop
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.tracking import kld, particle_filter as pf

    _, O, j, p = runs
    np.testing.assert_allclose(p["c0"], j["c0"], atol=1e-5)
    assert p["n_ref"] == j["n_ref"]
    ref, jref = make_cloud(j["ref_xyz"], device="cpu"), jmake(jnp.asarray(j["ref_xyz"]))
    sn = torch.tensor(O["step_noise"])
    kw = dict(bin_size=O["kld"]["bin_size"], epsilon=O["kld"]["epsilon"],
              z_delta=O["kld"]["z_delta"])
    jax.clear_caches()
    orig, jbf.nn1 = jbf.nn1, _interpret_nn1
    try:
        for (ks, ps, scene_xyz), dk, dp in zip(j["track"]["states"], j["draws"]["kld"],
                                               j["draws"]["pf"]):
            cap = rp.pow2(len(scene_xyz))
            scene = make_cloud(scene_xyz, capacity=cap, device="cpu")
            jscene = jmake(jnp.asarray(scene_xyz), capacity=cap)
            jk, jpose_k = jkld.step_tracker_kld(ks, jref, jscene, step_noise=jnp.asarray(sn), **kw)
            jp, jpose_p = jpf.step_tracker(ps, jref, jscene, step_noise=jnp.asarray(sn))
            kst = interop.kld_state_from_arrays(*ks[:3], device="cpu")
            pst = interop.tracker_state_from_arrays(*ps[:3], device="cpu")
            nk, pose_k = kld.step_tracker_kld_core(kst, ref, scene, dk, step_noise=sn, **kw)
            npf, pose_p = pf.step_tracker_core(pst, ref, scene, dp, step_noise=sn)
            np.testing.assert_allclose(pose_k.numpy(), np.asarray(jpose_k), atol=1e-4)
            np.testing.assert_allclose(pose_p.numpy(), np.asarray(jpose_p), atol=1e-4)
            np.testing.assert_array_equal(nk.active.numpy(), np.asarray(jk.active))
            for new, want, weigh, st, d in ((nk, jk, kld.weigh_kld, kst, dk),
                                            (npf, jp, pf.weigh, pst, dp)):
                w = weigh(st, ref, scene, d, sn)[1].numpy().astype(np.float64)
                P = len(w)
                cum = np.cumsum(w) / w.sum()
                near = np.abs(float(d.u0) + np.arange(P)[:, None] / P - cum[None, :]).min(1) \
                    <= 1e-4
                apart = np.abs(new.particles.numpy() - np.asarray(want.particles)).max(1) > 1e-4
                assert not (apart & ~near).any() and near.sum() <= P // 8
    finally:
        jbf.nn1 = orig
        jax.clear_caches()


def test_path_o_klt_and_corners_match_jax(runs):
    _, O, j, p = runs
    for name in ("agast", "brisk", "brisk_kps", "trajkovic"):
        np.testing.assert_array_equal(p[name], j[name])
    H, W = O["shape"]
    assert [len(s_[0]) for s_ in p["klt"]] == [len(s_[0]) for s_ in j["klt"]]
    for (pa, na, oka), (pb, nb, okb) in zip(p["klt"], j["klt"]):
        np.testing.assert_allclose(pa, pb, atol=1e-3)      # the last step's survivors
        inner = (pa[:, 0] > 6) & (pa[:, 0] < H - 6) & (pa[:, 1] > 6) & (pa[:, 1] < W - 6)
        np.testing.assert_allclose(na[inner], nb[inner], atol=1e-3)
        np.testing.assert_array_equal(oka[inner], okb[inner])


def test_path_o_metrics_on_the_port(runs):
    inp, O, _, p = runs
    m = cs.path_o_metrics(inp, p, O)
    assert m["cv"] >= 0.9 and all(m["files"])
    assert m["found"] == 1.0 and m["clutter"] == 0
    assert m["crf_permutohedral"] > m["crf_before"] and m["crf_grid"] > m["crf_before"]
    assert np.isfinite(m["rmse_kld"]) and np.isfinite(m["rmse_pf"])
    assert m["klt_share"] > 0.5 and m["n_agast"] > 0
