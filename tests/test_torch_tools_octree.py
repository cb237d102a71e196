"""The port's octree-slice command-line tools on the CPU (``--device cpu``),
beside the JAX package's tools on the same files: ``generate`` writes the
same points, ``obj_rec_ransac_orr_octree_zprojection`` the same image
bytes, ``voxel_grid_occlusion_estimation`` the same visible and occluded
voxel centres (the JAX tool lists them in set order, the port in cell
order: compared as sorted rows) and counts; ``timed_trigger_test`` fires
its trigger."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import re

import numpy as np
import pytest
import torch

from pcl_tpu.tools import generate as j_generate
from pcl_tpu.tools import obj_rec_ransac_orr_octree_zprojection as j_zproj
from pcl_tpu.tools import timed_trigger_test as j_trigger
from pcl_tpu.tools import voxel_grid_occlusion_estimation as j_occlusion

from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core.cloud import from_numpy
from pcl_tpu_torch.tools import generate as t_generate
from pcl_tpu_torch.tools import obj_rec_ransac_orr_octree_zprojection as t_zproj
from pcl_tpu_torch.tools import timed_trigger_test as t_trigger
from pcl_tpu_torch.tools import voxel_grid_occlusion_estimation as t_occlusion

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    """A box in front of a wall and a floor, seen from the origin."""
    rng = np.random.default_rng(0)
    wall = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-1, 1.5, 300), np.full(300, 5.0)], 1)
    floor = np.stack([rng.uniform(-2, 2, 300), np.full(300, -1.0), rng.uniform(1, 5, 300)], 1)
    box = np.stack([rng.uniform(-0.5, 0.5, 200), rng.uniform(-0.5, 0.5, 200),
                    rng.uniform(2.5, 3.0, 200)], 1)
    pts = np.concatenate([wall, floor, box]).astype(np.float32)
    path = str(tmp_path_factory.mktemp("octree_tools") / "scene.pcd")
    tio.save(path, from_numpy(pts, device="cpu"))
    return path


def _counts(text):
    return [int(v) for v in re.findall(r"\d+", text)]


def test_timed_trigger_test_fires(capsys):
    for tool in (t_trigger, j_trigger):
        assert tool.main(["-interval", "0.02", "-duration", "0.2"]) == 0
        out = capsys.readouterr().out
        assert _counts(out)[0] >= 2


@pytest.mark.parametrize("argv", [["-n", "500", "-seed", "3", "-min", "-2", "-max", "5"],
                                  ["-n", "300", "-distribution", "normal", "-stddev", "0.5"]],
                         ids=["uniform", "normal"])
def test_generate_writes_the_jax_points(tmp_path, capsys, argv):
    t_out, j_out = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_generate.main([t_out, *argv, *CPU]) == 0
    assert j_generate.main([j_out, *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" -> ")[0] == out[1].split(" -> ")[0]
    a, b = tio.load(t_out, device="cpu"), tio.load(j_out, device="cpu")
    assert torch.equal(a.xyz, b.xyz) and torch.equal(a.mask, b.mask)


@pytest.mark.parametrize("leaf", ["0.05", "0.3"])
def test_zprojection_writes_the_jax_image(scene_file, tmp_path, capsys, leaf):
    t_out, j_out = str(tmp_path / "t.pgm"), str(tmp_path / "j.pgm")
    assert t_zproj.main([scene_file, t_out, "-leaf", leaf, *CPU]) == 0
    assert j_zproj.main([scene_file, j_out, "-leaf", leaf]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" -> ")[0] == out[1].split(" -> ")[0]
    with open(t_out, "rb") as f, open(j_out, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("extra", [[], ["--occluded"], ["-viewpoint", "1", "0.5", "-1"]],
                         ids=["visible", "occluded", "viewpoint"])
def test_occlusion_writes_the_jax_voxels(scene_file, tmp_path, capsys, extra):
    t_out, j_out = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_occlusion.main([scene_file, t_out, "-leaf", "0.2", *extra, *CPU]) == 0
    assert j_occlusion.main([scene_file, j_out, "-leaf", "0.2", *extra]) == 0
    out = capsys.readouterr().out.splitlines()
    assert _counts(out[0]) == _counts(out[1])
    n_occ = _counts(out[0])[2]
    assert n_occ > 0 and _counts(out[0])[1] > 0
    a = tio.load(t_out, device="cpu").xyz.numpy()
    b = tio.load(j_out, device="cpu").xyz.numpy()
    order = lambda p: p[np.lexsort(p.T[::-1])]               # noqa: E731
    np.testing.assert_array_equal(order(a), order(b))


@pytest.mark.parametrize("tool", [t_generate, t_zproj, t_occlusion],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_tools_ask_for_the_card_by_default(scene_file, monkeypatch, tmp_path, tool):
    """No silent move to the CPU: without a card and without --device cpu the
    tool fails with the error the constructor raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path / "o.pcd")] if tool is t_generate else [scene_file,
                                                                 str(tmp_path / "o.out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
