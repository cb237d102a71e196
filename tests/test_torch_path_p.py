"""Path P's chain at 80 x 60 (``chip_smoke.P_SMALL``) on the port beside the
JAX package's calls (``tests/rehearse_path_p.jax_chain``: the same chain on
``JaxP``, one shape per JAX function but the voxel grids'), then
``path_p_metrics`` and ``p_checks``' exact checks on the port's run.

Tolerances (the slice's unit tests' own):
- (a) Disparities equal wherever the best cost beats the runner-up by more
  than 1e-5 relative (ROADMAP C88, C89), those pixels at least 99%; the
  stereo cloud equal where the disparities are; the DEM equal.
- (b) The voxel grids' counts equal and their centroids to 1e-5 m; ICP's
  transform to 1e-4 (its iteration count may differ where the convergence
  test lies near its threshold: the two 1-NN round apart, C1).
- (c) Both packages take the port's integral-image normals; the JAX
  package's own gradient-mode normals agree with them to 1e-3 on 99% of the
  pixels and to 1e-2 on all (the float32 integral images round apart at
  the room's 2-7 m, C26; my CPU run: p99 5.0e-4, largest 1.2e-3). Edge
  labels, their indices, every extractor's image and the image CLIs'
  clouds equal.
- (d) Each candidate's likelihood to 1e-5 of the sum of its terms'
  magnitudes (C92); the best candidate equal, the true pose.
- (e) Half-edge meshes, boundary loops, one-rings and the round trips
  equal; ``mesh_sampling``'s points equal (numpy draws, C93); the scans'
  points within 1e-5 m of the JAX tools' on 99%; the scans' surface error
  at p99 to 1e-4 m.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest
import torch

import chip_smoke as cs
import rehearse_path_p as rp
from test_torch_stereo import _firm, _margins


@pytest.fixture(scope="module")
def runs():
    P = cs.P_SMALL
    inp = cs.path_p_inputs(P)
    p, _ = cs.path_p_chain(inp, P, "cpu")
    j, _ = rp.jax_chain(inp, P, normals=p["normals"])
    return inp, P, j, p


def test_path_p_stereo_matches_jax(runs):
    from pcl_tpu_torch.stereo import advanced, matching

    inp, P, j, p = runs
    L, R = torch.from_numpy(inp["left"]), torch.from_numpy(inp["right"])
    D = P["max_disparity"]
    cl = matching.block_costs(L, R, D, 3).numpy()
    cr = matching.block_costs(L, R, D, 3, right_view=True).numpy()
    firm = _firm(_margins(cl, 0), _margins(cr, 0), np.argmin(cl, 0))
    agg = advanced.adaptive_aggregate(L, R, D).numpy()
    rc = np.stack([np.roll(agg[..., k], -k, 1) for k in range(D)], -1)
    firm_ad = _firm(_margins(agg, -1), _margins(rc, -1), np.argmin(agg, -1))
    for key, f in (("bm", firm), ("ad", firm_ad)):
        assert f.mean() >= 0.99
        np.testing.assert_array_equal(p[key][f], j[key][f])
    same = (p["bm"] == j["bm"]).reshape(-1)
    valid = (p["bm"] > 0).reshape(-1)
    assert len(p["stereo_xyz"]) == len(j["stereo_xyz"]) > 1000
    if same.all():
        np.testing.assert_array_equal(p["stereo_xyz"], j["stereo_xyz"])
    assert valid.sum() == len(p["stereo_xyz"])
    for a, b in zip(p["dem"], j["dem"]):
        np.testing.assert_array_equal(a, b)


def test_path_p_icp_matches_jax(runs):
    _, _, j, p = runs
    for key in ("vox_stereo", "vox_kinect"):
        assert p[key].shape == j[key].shape
        np.testing.assert_allclose(p[key], j[key], atol=1e-5, rtol=0)
    np.testing.assert_allclose(p["icp"][0], j["icp"][0], atol=1e-4)
    assert p["icp"][1] and j["icp"][1]


def test_path_p_edges_images_and_clis_match_jax(runs):
    inp, _, j, p = runs
    jn, _ = rp.JaxP().normals(inp["xyz"], inp["valid"])
    pn = p["normals"][0]
    v = inp["valid"]
    gap = np.abs(jn - pn).max(-1)[v]
    assert np.mean(gap <= 1e-3) >= 0.99 and gap.max() <= 1e-2
    np.testing.assert_array_equal(p["labels"], j["labels"])
    for a, b in zip(p["label_idx"], j["label_idx"]):
        np.testing.assert_array_equal(a, b)
    assert sorted(p["images"]) == sorted(j["images"])
    for k in p["images"]:
        assert p["images"][k].dtype == j["images"][k].dtype
        np.testing.assert_array_equal(p["images"][k], j["images"][k])
    assert p["images_back"] == j["images_back"] and all(p["images_back"].values())
    for k in ("cli_png_z", "cli_png_rgb"):
        np.testing.assert_array_equal(p[k], j[k])
    for k in ("png2pcd", "tiff2pcd"):
        for a, b in zip(p[k], j[k]):
            np.testing.assert_array_equal(a, b)


def test_path_p_likelihood_matches_jax(runs):
    from pcl_tpu_torch import simulation
    from pcl_tpu_torch.core.cloud import make_cloud

    inp, P, j, p = runs
    H, W = P["shape"]
    model = make_cloud(inp["xyz"][inp["valid"]], device="cpu")
    scale = []
    for T in cs.p_grid_poses(P["steps"]):
        r = simulation.render_depth(model, torch.from_numpy(T.astype(np.float32)), inp["intr"],
                                    H, W).numpy()
        both = (r > 0) & (inp["depth"] > 0)
        d = r.astype(np.float64) - inp["depth"]
        mix = 0.9 * np.exp(-0.5 * (d / 0.05) ** 2) / (0.05 * 2.5066283) + 0.02
        scale.append(np.abs(np.where(both, np.log(np.maximum(mix, 1e-12)), 0.0)).sum())
    np.testing.assert_array_less(np.abs(p["ll"] - j["ll"]), 1e-5 * np.array(scale))
    assert int(np.argmax(p["ll"])) == int(np.argmax(j["ll"])) == 62


def test_path_p_meshes_and_tools_match_jax(runs):
    from scipy.spatial import cKDTree

    _, _, j, p = runs
    assert sorted(p["he"]) == sorted(j["he"]) == ["box", "cylinder", "sheet", "sphere"]
    for name in p["he"]:
        a, b = p["he"][name], j["he"][name]
        np.testing.assert_array_equal(a["he_next"], b["he_next"])
        assert (a["euler"], a["manifold"], a["n"], a["faces_back"]) == \
            (b["euler"], b["manifold"], b["n"], b["faces_back"])
        for x, y in zip(a["loops"] + a["rings"], b["loops"] + b["rings"], strict=True):
            np.testing.assert_array_equal(x, y)
    assert p["sheet_faces"] == j["sheet_faces"]
    assert sorted(p["trips"]) == sorted(j["trips"])
    for key, a in p["trips"].items():
        b = j["trips"][key]
        if key.split()[0] in ("m", "vs"):
            assert abs(len(a) - len(b)) <= 0.01 * len(b)
            d, _ = cKDTree(b).query(a)
            assert np.mean(d <= 1e-5) >= 0.99
        elif key.startswith("ifs"):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)
    dp = np.percentile(np.sqrt(p["scan_nn"][1]), 99)
    dj = np.percentile(np.sqrt(j["scan_nn"][1]), 99)
    assert abs(dp - dj) <= 1e-4


def test_path_p_checks_hold_on_the_port(runs):
    """``p_checks``' exact checks pass on the port's run; the measured ones
    are only printed here (``P_LIMITS`` are set for VGA)."""
    inp, P, _, p = runs
    m = cs.path_p_metrics(inp, p, P)
    failed = []
    cs.p_checks(m, {k: None for k in cs.P_LIMITS}, lambda ok, what: ok or failed.append(what))
    assert failed == []
    assert m["ll_best"] == 62 and m["icp_converged"]
    assert m["he"]["sheet"]["loops"] > 0 and m["he"]["sheet"]["manifold"]
