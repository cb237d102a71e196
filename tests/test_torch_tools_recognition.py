"""The port's recognition command-line tools on the CPU (``--device cpu``),
beside the JAX package's tools on the same organized RGB PCD files.

- ``train_linemod_template`` writes the same template (``.npz`` arrays
  equal, ``.lmt`` bytes equal), and ``linemod_detection`` and
  ``match_linemod_template`` print the same detections from either
  package's file. The frame's orientations lie off the quantiser's bin
  edges (ROADMAP C78), which the test checks first.
- The ObjRecRANSAC tools draw at random: the port from a ``torch.Generator``,
  the JAX package from its keys (C17). On a scene that holds the model, both
  ``obj_rec_ransac_result`` runs find its pose (to 1e-3) with the same
  support to 1e-2, both lists of accepted hypotheses are non-empty, and the
  pair tools find the same number of valid pairs with their measured widths
  within the distance tolerance.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import re

import numpy as np
import pytest
import torch

from test_torch_orr_linemod import _bumpy, _edge_free, _normal_angle64

from pcl_tpu.tools import linemod_detection as j_detect
from pcl_tpu.tools import match_linemod_template as j_match
from pcl_tpu.tools import obj_rec_ransac_accepted_hypotheses as j_accepted
from pcl_tpu.tools import obj_rec_ransac_hash_table as j_hash
from pcl_tpu.tools import obj_rec_ransac_model_opps as j_model_opps
from pcl_tpu.tools import obj_rec_ransac_result as j_result
from pcl_tpu.tools import obj_rec_ransac_scene_opps as j_scene_opps
from pcl_tpu.tools import train_linemod_template as j_train

from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core.cloud import from_numpy
from pcl_tpu_torch.tools import linemod_detection as t_detect
from pcl_tpu_torch.tools import match_linemod_template as t_match
from pcl_tpu_torch.tools import obj_rec_ransac_accepted_hypotheses as t_accepted
from pcl_tpu_torch.tools import obj_rec_ransac_hash_table as t_hash
from pcl_tpu_torch.tools import obj_rec_ransac_model_opps as t_model_opps
from pcl_tpu_torch.tools import obj_rec_ransac_result as t_result
from pcl_tpu_torch.tools import obj_rec_ransac_scene_opps as t_scene_opps
from pcl_tpu_torch.tools import train_linemod_template as t_train

CPU = ["--device", "cpu"]


def _organized(xyz, valid, rgb):
    H, W = valid.shape
    pts = np.where(valid[..., None], xyz, np.nan).reshape(-1, 3).astype(np.float32)
    return from_numpy(pts, attrs={"rgb": rgb.reshape(-1, 3)}, width=W, height=H,
                      device="cpu")


def _box_frame(cy, cx, H=40, W=56):
    """A tilted box face in front of a tilted wall, coloured by its place."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    depth = 2.0 + 0.0031 * xx + 0.0017 * yy
    inside = (yy >= cy) & (yy < cy + 14) & (xx >= cx) & (xx < cx + 14)
    depth = np.where(inside, 1.2 + 0.017 * (xx - cx) + 0.011 * (yy - cy), depth)
    u = (xx - W / 2) / 50.0
    v = (yy - H / 2) / 50.0
    xyz = np.stack([u * depth, v * depth, depth], -1).astype(np.float32)
    valid = np.ones((H, W), bool)
    valid[::9, ::13] = False
    rgb = np.where(inside[..., None], [0.8, 0.2, 0.1], [0.3, 0.4, 0.6]).astype(np.float32)
    return xyz, valid, rgb


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("linemod_tools")
    out = {}
    for name, (cy, cx) in (("train", (8, 10)), ("scene", (20, 34))):
        xyz, valid, rgb = _box_frame(cy, cx)
        # every normal orientation lies off a bin edge (C78)
        assert _edge_free(_normal_angle64(xyz))[valid].all()
        path = str(d / f"{name}.pcd")
        tio.save(path, _organized(xyz, valid, rgb))
        out[name] = path
    return d, out


@pytest.mark.parametrize("ext", ["npz", "lmt"])
def test_train_linemod_template_writes_the_jax_template(frames, capsys, ext):
    d, f = frames
    t_out, j_out = str(d / f"t.{ext}"), str(d / f"j.{ext}")
    region = ["-region", "6", "8", "18", "18"]
    assert t_train.main([f["train"], t_out, *region, "-n_features", "40", *CPU]) == 0
    assert j_train.main([f["train"], j_out, *region, "-n_features", "40"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and "features" in out[0]
    if ext == "lmt":
        assert open(t_out, "rb").read() == open(j_out, "rb").read()
    else:
        a, b = np.load(t_out), np.load(j_out)
        for k in ("offsets", "bins", "modality", "height", "width"):
            np.testing.assert_array_equal(a[k], b[k])


def test_train_linemod_template_default_region(frames, capsys):
    d, f = frames
    assert t_train.main([f["train"], str(d / "td.npz"), *CPU]) == 0
    assert j_train.main([f["train"], str(d / "jd.npz")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


@pytest.mark.parametrize("ext", ["npz", "lmt"])
def test_linemod_detection_prints_the_jax_detections(frames, capsys, ext):
    d, f = frames
    tmpl = str(d / f"det.{ext}")
    assert j_train.main([f["train"], tmpl, "-region", "8", "10", "14", "14",
                         "-n_features", "30"]) == 0
    capsys.readouterr()
    for tool, extra in ((t_detect, CPU), (j_detect, [])):
        assert tool.main([f["scene"], tmpl, tmpl, "-threshold", "0.7", *extra]) == 0
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:] and "score=" in out[0]
    m = re.search(r"\(y=(\d+), x=(\d+)\)", out[0])
    assert abs(int(m.group(1)) - 20) <= 3 and abs(int(m.group(2)) - 34) <= 3


def test_match_linemod_template_prints_the_jax_detections(frames, capsys):
    d, f = frames
    tmpl = str(d / "match.npz")
    assert t_train.main([f["train"], tmpl, "-region", "8", "10", "14", "14", *CPU]) == 0
    capsys.readouterr()
    assert t_match.main([f["scene"], tmpl, "-threshold", "0.6", *CPU]) == 0
    assert j_match.main([f["scene"], tmpl, "-threshold", "0.6"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:] and out


@pytest.fixture(scope="module")
def orr_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("orr_tools")
    mxyz, mnrm = _bumpy(300, 0)
    ang = 0.5
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]],
                 np.float32)
    t = np.float32([0.8, -0.2, 1.5])
    sxyz = np.concatenate([mxyz @ R.T + t, np.random.default_rng(3).uniform(
        -1, 1, (60, 3)).astype(np.float32) + np.float32([3, 0, 0])])
    snrm = np.concatenate([mnrm @ R.T, np.tile(np.float32([0, 0, 1]), (60, 1))])
    paths = {}
    for name, xyz, nrm in (("model", mxyz, mnrm), ("scene", sxyz, snrm)):
        paths[name] = str(d / f"{name}.pcd")
        tio.save(paths[name], from_numpy(xyz.astype(np.float32),
                                         attrs={"normal": nrm.astype(np.float32)}, device="cpu"))
    paths["bare"] = str(d / "bare.pcd")
    tio.save(paths["bare"], from_numpy(mxyz, device="cpu"))
    return d, paths, R, t


def _floats(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", line)]


def test_obj_rec_ransac_result_finds_the_pose_as_the_jax_tool(orr_files, capsys):
    d, p, R, t = orr_files
    args = [p["model"], p["scene"], "-pair_width", "0.6", "-hypotheses", "64"]
    assert t_result.main([*args, "-output", str(d / "t_aligned.pcd"), *CPU]) == 0
    assert j_result.main([*args, "-output", str(d / "j_aligned.pcd")]) == 0
    out = capsys.readouterr().out.splitlines()
    sup = [float(re.search(r"support=([\d.]+)", ln).group(1)) for ln in out if "support=" in ln]
    assert len(sup) == 2 and abs(sup[0] - sup[1]) <= 1e-2 and min(sup) > 0.9
    a = tio.load(str(d / "t_aligned.pcd"), device="cpu").xyz.numpy()
    b = tio.load(str(d / "j_aligned.pcd"), device="cpu").xyz.numpy()
    np.testing.assert_allclose(a, b, atol=1e-3)
    np.testing.assert_allclose(a[:5], (_bumpy(300, 0)[0] @ R.T + t)[:5], atol=1e-3)


def test_obj_rec_ransac_accepted_hypotheses_as_the_jax_tool(orr_files, capsys):
    _, p, _, _ = orr_files
    args = [p["model"], p["scene"], "-pair_width", "0.6", "-hypotheses", "64",
            "-accept", "0.5", "-top", "3"]
    assert t_accepted.main([*args, *CPU]) == 0
    assert j_accepted.main(args) == 0
    out = capsys.readouterr().out
    counts = [int(v) for v in re.findall(r"\] (\d+)/64 accepted", out)]
    assert len(counts) == 2 and min(counts) > 0
    top = [float(v) for v in re.findall(r"support=([\d.]+)", out)]
    assert max(top) > 0.95


@pytest.mark.parametrize("tools", [(t_model_opps, j_model_opps), (t_scene_opps, j_scene_opps)],
                         ids=["model", "scene"])
def test_oriented_pair_tools_as_the_jax_tools(orr_files, capsys, tools, tmp_path):
    _, p, _, _ = orr_files
    src = p["model"] if tools[0] is t_model_opps else p["bare"]
    for tool, extra, name in ((tools[0], CPU, "t"), (tools[1], [], "j")):
        assert tool.main([src, "-pair_width", "0.4", "-pairs", "200",
                          "-output", str(tmp_path / f"{name}.pcd"), *extra]) == 0
    out = capsys.readouterr().out.splitlines()
    n = [int(re.search(r"\] (\d+)/200", ln).group(1)) for ln in out]
    assert n[0] == n[1] == 200
    widths = [_floats(ln)[-2] for ln in out]
    assert all(abs(w - 0.4) < 0.05 for w in widths)
    sizes = [len(tio.load(str(tmp_path / f"{k}.pcd"), device="cpu").xyz) for k in "tj"]
    assert sizes == [400, 400]


def test_hash_table_tool_as_the_jax_tool(orr_files, capsys, tmp_path):
    _, p, _, _ = orr_files
    for tool, extra, name in ((t_hash, CPU, "t"), (j_hash, [], "j")):
        assert tool.main([p["bare"], "-pair_width", "0.4", "-pairs", "500", "-bins", "8",
                          "-output", str(tmp_path / f"{name}.npy"), *extra]) == 0
    out = capsys.readouterr().out.splitlines()
    n = [int(re.search(r"\] (\d+) pairs", ln).group(1)) for ln in out]
    assert n[0] == n[1] == 500
    a, b = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert a.shape == b.shape == (8, 8, 8) and a.sum() == b.sum() == 500


@pytest.mark.parametrize("tool", [t_detect, t_train, t_result, t_hash],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_tools_ask_for_the_card_by_default(frames, orr_files, monkeypatch, tool):
    """No silent move to the CPU: without a card and without --device cpu
    each tool fails with the error the loader raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, f = frames
    _, p, _, _ = orr_files
    argv = {t_detect: [f["scene"], str(d / "det.npz")], t_train: [f["train"], str(d / "x.npz")],
            t_result: [p["model"], p["scene"]], t_hash: [p["model"]]}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
