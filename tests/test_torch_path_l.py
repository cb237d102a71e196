"""The slice as a whole against the JAX package on the CPU: path L's chain
(``chip_smoke.path_l_chain``) at 80 x 60 (``chip_smoke.L_SMALL``: path G's
room, frame 0, radii grown with the pixels) beside the JAX package's
(``tests/rehearse_path_l.jax_chain``) on the port's front end: the frame's
k-NN normals, the voxels with their normals, the wall's points and the seeds.

- (a), (b): plane labels, components, the fast mesh, the floor's hull, the
  prism and the clusters equal; plane coefficients to 1e-6.
- (c): MLS to 1e-5 m; GP3's triangles equal; Hoppe's triangles equal where
  no SDF sign differs and its vertices to 1e-5 but for 0.5% (a corner at a
  1-NN near-tie, ROADMAP C55), else within a tenth of a cell; Poisson's and
  RBF's meshes within a tenth of a cell and 0.2 m (C56, C66); the plain
  B-spline fit's residual to 1e-5 m; smoothed-surface keypoints within 2 of
  each other.
- (d): supervoxels, LCCP, CPC, min-cut, GrabCut, seeded hue equal; random
  walker labels on 99%; the unary classifier, fed the JAX package's draws
  (C61), equal.
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
from scipy.spatial import cKDTree

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
cs = importlib.import_module("chip_smoke")
rehearse = importlib.import_module("rehearse_path_l")


@pytest.fixture(scope="module")
def chains():
    L = cs.L_SMALL
    frame = cs.path_l_frame(L)
    port, _ = cs.path_l_chain(frame, L, torch.device("cpu"))
    inp = {k: port[k] for k in rehearse.INPUTS}
    ref, _ = rehearse.jax_chain(frame, inp, L, full=False)
    return frame, port, ref, L


def _haus(a, b):
    return max(cKDTree(a).query(b)[0].max(), cKDTree(b).query(a)[0].max())


def test_organized_and_tabletop_match_jax(chains):
    frame, port, ref, L = chains
    assert np.array_equal(port["plane_labels"], ref["plane_labels"])
    assert len(port["regions"]) == len(ref["regions"]) >= 2
    for a, b in zip(port["regions"], ref["regions"]):
        np.testing.assert_allclose(a.coefficients, b.coefficients, atol=1e-6)
    assert np.array_equal(port["cc_labels"], np.asarray(ref["cc_labels"]))
    for a, b in zip(port["fast_mesh"], ref["fast_mesh"]):
        assert np.array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(port["hull"], ref["hull"])
    assert port["concave_edges"] == ref["concave_edges"]
    assert np.array_equal(port["prism"], ref["prism"])
    assert np.array_equal(port["clusters"], ref["clusters"])
    mp, mj = cs.path_l_metrics(frame, port, L), cs.path_l_metrics(frame, ref, L)
    assert mp["cluster_objects"] == mj["cluster_objects"] and len(mp["planes"]) >= 2


def test_reconstruction_matches_jax(chains):
    _, port, ref, L = chains
    np.testing.assert_allclose(port["mls_xyz"], ref["mls_xyz"], atol=1e-5)
    assert abs(int(port["keypoints"].sum()) - int(np.asarray(ref["keypoints"]).sum())) <= 2
    assert np.array_equal(port["gp3"][1], ref["gp3"][1]) and len(port["gp3"][1]) > 1000
    (vp, fp), (vj, fj) = port["hoppe"], ref["hoppe"]
    lo, hi = (np.asarray(a) for a in (port["vox_xyz"].min(0), port["vox_xyz"].max(0)))
    cell = float((hi - lo).max()) / (L["hoppe_res"] - 1)
    if fp.shape == fj.shape and np.array_equal(fp, fj):
        # a vertex whose cell has a corner at a 1-NN near-tie moves (C55)
        near = np.abs(vp - vj).max(1) > 1e-5
        assert near.mean() <= 5e-3 and np.abs(vp - vj).max() <= 0.1 * cell
    else:
        assert _haus(vp, vj) <= 0.1 * cell
    cell_p = 1.15 * float((hi - lo).max()) / ((1 << L["poisson_depth"]) - 1)
    assert _haus(port["poisson"][0], ref["poisson"][0]) <= 0.1 * cell_p
    assert _haus(port["rbf"][0], ref["rbf"][0]) <= 0.2
    np.testing.assert_allclose(port["bspline_residual"][0], ref["bspline_residual"][0], atol=1e-5)


def test_segmentation_matches_jax(chains):
    _, port, ref, _ = chains
    for key in ("sv_labels", "lccp", "cpc", "mincut", "grab", "hue"):
        assert np.array_equal(port[key], np.asarray(ref[key])), key
    assert (port["walker"] == ref["walker"]).mean() >= 0.99
    assert len(np.unique(port["sv_labels"])) > 20


def test_unary_classifier_on_the_jax_draws(chains):
    from pcl_tpu.features import estimate_fpfh as j_fpfh
    from pcl_tpu.core.cloud import Cloud as JCloud

    from pcl_tpu_torch.segmentation import UnaryClassifier

    _, port, ref, L = chains
    vc = port["vox_cluster"]
    jc = JCloud(xyz=jnp.asarray(port["vox_xyz"]), mask=jnp.ones(len(vc), bool),
                attrs={"normal": jnp.asarray(port["vox_normal"])})
    f = np.asarray(j_fpfh(jc, k=L["fpfh_k"]))
    feats = [f[vc == c] for c in range(vc.max() + 1)]
    draws = [np.array(jax.random.categorical(
        jax.random.PRNGKey(0),
        jnp.log(jnp.ones(len(x)) / len(x) + 1e-30)[None, :].repeat(min(8, len(x)), 0)))
        for x in feats]
    clf = UnaryClassifier().train(feats, init_indices=draws, device="cpu")
    np.testing.assert_array_equal(clf.segment(f), ref["unary"])
