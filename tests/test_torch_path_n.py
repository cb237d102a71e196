"""The slice as a whole against the JAX package on the CPU: path N's chain
(``chip_smoke.path_n_chain``) at 80 x 60 (``chip_smoke.N_SMALL``: path L's
small frame of the room, the models rendered from a turned camera, lengths
grown with the pixels) beside the JAX package's
(``tests/rehearse_path_n.jax_chain``) on the port's front end (voxels,
normals, SHOT correspondences and BOARD frames), the port fed the JAX
package's draws (ROADMAP C17).

- (a): every grouper's instances and members equal, transforms to 1e-5,
  also after SAC refinement.
- (b): trimmed ICP's poses within 2 mm of the JAX package's in their
  distance to the box (C1); the three verifiers' decisions on the port's
  hypotheses equal.
- (c): ObjRecRANSAC's pose to 1e-3 and its support to 2 model points (C1);
  the pair histogram's valid pairs equal.
- (d): LINEMOD's template and detections equal; the distance map and the
  eroded mask equal.
- (e): the scene's clusters and their VFH labels equal.
- (f): ISM's vote count within 2% and its strongest peak within one
  sampling cell of the JAX package's (FPFH's bins, C19, shape the codebook).
- (g): the forest's detections equal (numpy on both sides).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
cs = importlib.import_module("chip_smoke")
rehearse = importlib.import_module("rehearse_path_n")


@pytest.fixture(scope="module")
def chains():
    N = cs.N_SMALL
    inp = cs.path_n_inputs(N)
    cpu = torch.device("cpu")
    front = cs.path_n_front(inp, N, cpu)
    ref, _, draws = rehearse.jax_chain(inp, rehearse.front_arrays(front), N, full=False)
    port, _ = cs.path_n_chain(inp, N, cpu, draws=draws, front=front)
    return inp, port, ref, N


def test_grouping_matches_jax(chains):
    _, port, ref, _ = chains
    for i in (3, 5):
        assert len(port["groups"][i]["cor"]["model_pts"]) > 10
        for k in ("gc", "hough", "gc_sac", "hough_sac"):
            (ia, ma, ta), (ib, mb, tb) = port["groups"][i][k], ref["groups"][i][k]
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(ma, mb)
            np.testing.assert_allclose(ta, tb, atol=1e-5)
    assert port["groups"][3]["hough"][0].any()


def test_verification_matches_jax(chains):
    """Trimmed ICP's poses lie as near the box in both packages (C1: the JAX
    package's CPU distances are the matmul identity's, which moves the
    trimmed set at these coordinates); the verifiers decide alike on the
    port's hypotheses."""
    import jax.numpy as jnp
    from pcl_tpu.recognition import verification as jver

    inp, port, ref, N = chains
    assert port["hyp_names"] == ref["hyp_names"]
    mp, mj = cs.path_n_metrics(inp, port, N), cs.path_n_metrics(inp, ref, N)
    for name in port["hyp_names"]:
        assert abs(mp["hyp_err"][name] - mj["hyp_err"][name]) <= 2e-3, name
    sub = cs.hv_subsample(port["models"][3][0], N)
    Ts = jnp.asarray(port["hyp_T"].astype(np.float32))
    ok = jnp.ones(len(Ts), bool)
    sx = jnp.asarray(port["scene_xyz"])
    sm = jnp.ones(len(port["scene_xyz"]), bool)
    for k, fn, kw in (("greedy", jver.greedy_hypothesis_verification, N["hv"]),
                      ("global", jver.global_hypothesis_verification,
                       dict(N["hv"], **N["hv_global"])),
                      ("papazov", jver.papazov_hypothesis_verification, N["hv"])):
        j = np.asarray(fn(jnp.asarray(sub), Ts, ok, sx, sm, **kw))
        np.testing.assert_array_equal(port["hv"][k], j)
    assert port["hv"]["global"].any()


def test_orr_matches_jax(chains):
    _, port, ref, _ = chains
    np.testing.assert_allclose(port["orr"][0], ref["orr"][0], atol=1e-3)
    n_model = len(port["models"][3][0])
    assert abs(port["orr"][1] - ref["orr"][1]) <= 2.0 / n_model
    assert port["hash"][1] == ref["hash"][1] and port["hash"][0].sum() == ref["hash"][0].sum()


def test_linemod_matches_jax(chains):
    _, port, ref, _ = chains
    a, b = port["lm_template"], ref["lm_template"]
    for f in ("offsets", "bins", "modality"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [(d.y, d.x, d.score) for d in port["lm"]] == [(d.y, d.x, d.score) for d in ref["lm"]]
    np.testing.assert_array_equal(port["dmap"], ref["dmap"])
    np.testing.assert_array_equal(port["eroded"], ref["eroded"])


def test_global_pipeline_matches_jax(chains):
    _, port, ref, _ = chains
    assert len(port["gp_clusters"]) == len(ref["gp_clusters"]) >= 1
    for a, b in zip(port["gp_clusters"], ref["gp_clusters"]):
        np.testing.assert_array_equal(np.sort(a, axis=0), np.sort(b, axis=0))
    assert [r.label for r in port["gp_vfh"]] == [r.label for r in ref["gp_vfh"]]


def test_ism_and_forest_match_jax(chains):
    _, port, ref, N = chains
    assert port["ism_model"].n_visual_words == ref["ism_model"].n_visual_words
    assert abs(port["ism_votes"] - ref["ism_votes"]) <= 0.02 * ref["ism_votes"]
    assert port["ism_peaks"] and ref["ism_peaks"]
    gap = float(np.linalg.norm(port["ism_peaks"][0][0] - ref["ism_peaks"][0][0]))
    assert gap <= N["ism_sampling"]
    assert port["faces"] == ref["faces"] and port["faces"]


def test_metrics_agree(chains):
    inp, port, ref, N = chains
    mp, mj = cs.path_n_metrics(inp, port, N), cs.path_n_metrics(inp, ref, N)
    assert mp["hv"] == mj["hv"] and mp["lm"] == mj["lm"] and mp["face"] == mj["face"]
    for k in ("gc box", "hough box", "gc_sac box", "hough_sac box"):
        assert mp[k][1:] == mj[k][1:]
        assert abs(mp[k][0] - mj[k][0]) <= 1e-4 or mp[k][0] == mj[k][0]
