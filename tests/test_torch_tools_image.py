"""The port's image, mesh and format CLIs on the CPU (``--device cpu``), on
files the test writes, beside the JAX package's CLIs on the same files.

Tolerances: the converters' outputs hold the JAX tools' points bit for bit
(their PCD and PLY bodies are each package's own writer's; ``.vtk``,
``.ifs``, OBJ and PNG files are byte for byte equal); ``png2pcd`` and
``tiff2pcd`` give the JAX clouds bit for bit; ``mesh_sampling`` draws the
JAX tool's numpy draws, so its points are equal bit for bit (ROADMAP C93);
``virtual_scanner`` and ``mesh2pcd`` make the same draws; their z-buffers
hold the same samples but where one projects within rounding of a half
pixel, and their depths round apart in the last bits (the two packages'
inverse and ``[N,3] @ [3,3]`` product, C92): at least 99% of the port's
points lie within 1e-5 m of a point of the JAX tool's, and the counts agree
to 1%. PLY and binary PCD files are compared as the points they hold (their
headers name their package).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib
import os

import numpy as np
import pytest

from pcl_tpu.core.cloud import from_numpy as jfrom
from pcl_tpu.io import pcd as jpcd
from pcl_tpu.io import ply as jply

from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core.cloud import to_numpy
from pcl_tpu_torch.io.png import save_depth_png
from pcl_tpu_torch.io.tiff import save_tiff

CPU = ["--device", "cpu"]
WRAPPERS = ["pcd2ply", "ply2pcd", "ply2ply", "xyz2pcd", "obj2pcd", "obj2ply", "obj2vtk",
            "pcd2vtk", "ply2vtk", "vtk2obj", "vtk2pcd", "vtk2ply"]


def _tools(name):
    return (importlib.import_module(f"pcl_tpu_torch.tools.{name}"),
            importlib.import_module(f"pcl_tpu.tools.{name}"))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _points(path):
    """A file's points and attributes by the port's reader."""
    xyz, attrs = to_numpy(tio.load(path, device="cpu"))
    return xyz, attrs


def _uv_sphere(c, r, n=12):
    th = np.linspace(0, np.pi, n + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    v = [c + r * np.array([0, 0, 1.0]), c - r * np.array([0, 0, 1.0])]
    v += [c + r * np.array([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)])
          for t in th for p in ph]
    m = len(ph)
    f = []
    for j in range(m):
        f.append((0, 2 + j, 2 + (j + 1) % m))
        last = 2 + (len(th) - 1) * m
        f.append((1, last + (j + 1) % m, last + j))
    for i in range(len(th) - 1):
        for j in range(m):
            a, b = 2 + i * m + j, 2 + i * m + (j + 1) % m
            f += [(a, a + m, b), (b, a + m, b + m)]
    return np.array(v, np.float32), np.array(f, np.int32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A mesh (a sphere and a box) as PLY with normals, as OBJ and as VTK;
    a cloud as PCD, PLY and XYZ; an organized cloud with RGB and intensity
    as PCD; a depth PNG; depth and RGB TIFF folders."""
    d = tmp_path_factory.mktemp("image_tools")
    rng = np.random.default_rng(14)
    sv, sf = _uv_sphere(np.array([0.0, 0.0, 0.0]), 0.3)
    bv = np.array([[x, y, z] for x in (0.5, 0.9) for y in (-0.2, 0.2) for z in (-0.2, 0.3)],
                  np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    bf = np.array([t for a, b, c, e in quads for t in ((a, b, c), (a, c, e))], np.int32) + len(sv)
    verts, faces = np.concatenate([sv, bv]), np.concatenate([sf, bf])
    nrm = verts - verts.mean(0)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    out = {"mesh_ply": str(d / "mesh.ply"), "mesh_obj": str(d / "mesh.obj"),
           "mesh_vtk": str(d / "mesh.vtk"), "cloud_pcd": str(d / "c.pcd"),
           "cloud_ply": str(d / "c.ply"), "cloud_xyz": str(d / "c.xyz"),
           "org_pcd": str(d / "org.pcd"), "depth_png": str(d / "depth.png"),
           "tiff_depth": str(d / "tdepth"), "tiff_rgb": str(d / "trgb")}
    jply.save(out["mesh_ply"], jfrom(verts, {"normal": nrm.astype(np.float32)}), faces=faces)
    from pcl_tpu.tools import ply2obj
    ply2obj.main([out["mesh_ply"], out["mesh_obj"]])
    from pcl_tpu.io.formats_extra import save_vtk
    save_vtk(out["mesh_vtk"], verts, faces)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    jpcd.save(out["cloud_pcd"], jfrom(xyz, {"rgb": rng.uniform(size=(500, 3)).astype(
        np.float32)}))
    jply.save(out["cloud_ply"], jfrom(xyz))
    np.savetxt(out["cloud_xyz"], xyz, fmt="%.9g")
    H, W = 24, 32
    v, u = np.mgrid[0:H, 0:W]
    depth = (2.0 + 0.5 * np.sin(u / 5.0) + 0.02 * v).astype(np.float32)
    depth[rng.random((H, W)) < 0.05] = 0.0
    org = np.stack([(u - 15.5) / 40 * depth, (v - 11.5) / 40 * depth, depth], -1)
    org = np.where(depth[..., None] > 0, org, np.nan).reshape(-1, 3).astype(np.float32)
    jpcd.save(out["org_pcd"], jfrom(org, {
        "rgb": rng.uniform(size=(H * W, 3)).astype(np.float32),
        "intensity": rng.uniform(0, 100, H * W).astype(np.float32)}, drop_nonfinite=True,
        width=W, height=H))
    save_depth_png(out["depth_png"], depth)
    os.makedirs(out["tiff_depth"])
    os.makedirs(out["tiff_rgb"])
    for i in range(2):
        save_tiff(os.path.join(out["tiff_depth"], f"f{i}.tif"),
                  (depth * 1000 + 7 * i).astype(np.uint16))
        save_tiff(os.path.join(out["tiff_rgb"], f"f{i}.tif"),
                  rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
    return out


SRC = {"pcd": "cloud_pcd", "ply": "cloud_ply", "xyz": "cloud_xyz", "obj": "mesh_obj",
       "vtk": "mesh_vtk"}


@pytest.mark.parametrize("name", WRAPPERS)
def test_converters_match_jax(name, files, tmp_path, capsys):
    a, b = name.split("2")
    t_mod, j_mod = _tools(name)
    src = files[SRC[a]]
    out_t, out_j = str(tmp_path / f"t.{b}"), str(tmp_path / f"j.{b}")
    if b == "obj":                                   # io.save has no OBJ writer (C86)
        with pytest.raises(ImportError):
            t_mod.main([src, out_t, *CPU])
        with pytest.raises(ImportError):
            j_mod.main([src, out_j])
        return
    assert t_mod.main([src, out_t, *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_mod.main([src, out_j]) == 0
    assert line_t.replace(out_t, "") == capsys.readouterr().out.replace(out_j, "")
    if b == "vtk":
        assert _bytes(out_t) == _bytes(out_j)
    (xt, at), (xj, aj) = _points(out_t), _points(out_j)
    np.testing.assert_array_equal(xt, xj)
    assert sorted(at) == sorted(aj)
    for k in at:
        np.testing.assert_array_equal(at[k], aj[k])


@pytest.mark.parametrize("ascii_", [False, True])
@pytest.mark.parametrize("ext", ["pcd", "ply"])
def test_convert_matches_jax(ascii_, ext, files, tmp_path, capsys):
    t_mod, j_mod = _tools("convert")
    flag = ["--ascii"] if ascii_ else []
    out_t, out_j = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    assert t_mod.main([files["org_pcd"], out_t, *flag, *CPU]) == 0
    assert j_mod.main([files["org_pcd"], out_j, *flag]) == 0
    if ascii_ and ext == "pcd":
        assert _bytes(out_t) == _bytes(out_j)
    (xt, at), (xj, aj) = _points(out_t), _points(out_j)
    np.testing.assert_array_equal(xt, xj)
    for k in at:
        np.testing.assert_array_equal(at[k], aj[k])


def test_ply2obj_matches_jax(files, tmp_path, capsys):
    t_mod, j_mod = _tools("ply2obj")
    out_t, out_j = str(tmp_path / "t.obj"), str(tmp_path / "j.obj")
    assert t_mod.main([files["mesh_ply"], out_t, *CPU]) == 0
    assert j_mod.main([files["mesh_ply"], out_j]) == 0
    assert _bytes(out_t) == _bytes(out_j)
    assert "vn " in open(out_t).read()


def test_png2pcd_matches_jax(files, tmp_path):
    t_mod, j_mod = _tools("png2pcd")
    for extra in ([], ["-fx", "40", "-fy", "41", "-cx", "15", "-cy", "11.5", "-scale", "500"]):
        out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
        assert t_mod.main([files["depth_png"], out_t, *extra, *CPU]) == 0
        assert j_mod.main([files["depth_png"], out_j, *extra]) == 0
        ct, cj = tio.load(out_t, device="cpu"), tio.load(out_j, device="cpu")
        assert (ct.width, ct.height) == (cj.width, cj.height) == (32, 24)
        np.testing.assert_array_equal(ct.mask.numpy(), cj.mask.numpy())
        np.testing.assert_array_equal(ct.xyz.numpy(), cj.xyz.numpy())


@pytest.mark.parametrize("field", ["z", "rgb", "intensity"])
def test_pcd2png_matches_jax(field, files, tmp_path):
    t_mod, j_mod = _tools("pcd2png")
    out_t, out_j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert t_mod.main([files["org_pcd"], out_t, "-field", field, *CPU]) == 0
    if field == "intensity":
        # the JAX tool calls ndarray.ptp, gone in numpy 2 (ROADMAP C93)
        with pytest.raises(AttributeError, match="ptp"):
            j_mod.main([files["org_pcd"], out_j, "-field", field])
        from pcl_tpu_torch.io.png import load_png
        i = tio.load(files["org_pcd"], device="cpu").attrs["intensity"].numpy().reshape(24, 32)
        want = (255 * (i - i.min()) / max(np.ptp(i), 1e-9)).astype(np.uint8)
        np.testing.assert_array_equal(load_png(out_t), want)
        return
    assert j_mod.main([files["org_pcd"], out_j, "-field", field]) == 0
    assert _bytes(out_t) == _bytes(out_j)


def test_tiff2pcd_matches_jax(files, tmp_path):
    t_mod, j_mod = _tools("tiff2pcd")
    for extra in ([], ["-rgb_dir", files["tiff_rgb"], "-focal", "40", "-scale", "500"]):
        dt, dj = tmp_path / "t", tmp_path / "j"
        assert t_mod.main([files["tiff_depth"], str(dt), *extra, *CPU]) == 0
        assert j_mod.main([files["tiff_depth"], str(dj), *extra]) == 0
        names = sorted(os.listdir(dt))
        assert names == sorted(os.listdir(dj)) == ["frame_000000.pcd", "frame_000001.pcd"]
        for n in names:
            ct, cj = (tio.load(str(x / n), device="cpu") for x in (dt, dj))
            np.testing.assert_array_equal(ct.xyz.numpy(), cj.xyz.numpy())
            np.testing.assert_array_equal(ct.mask.numpy(), cj.mask.numpy())
            assert sorted(ct.attrs) == sorted(cj.attrs)
            for k in ct.attrs:
                np.testing.assert_array_equal(ct.attrs[k].numpy(), cj.attrs[k].numpy())
    assert t_mod.main([str(tmp_path / "t"), str(tmp_path / "none"), *CPU]) == 1


@pytest.mark.parametrize("mesh", ["mesh_ply", "mesh_obj"])
def test_mesh_sampling_matches_jax(mesh, files, tmp_path):
    t_mod, j_mod = _tools("mesh_sampling")
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_mod.main([files[mesh], out_t, "-n_samples", "3000", "-seed", "3", *CPU]) == 0
    assert j_mod.main([files[mesh], out_j, "-n_samples", "3000", "-seed", "3"]) == 0
    np.testing.assert_array_equal(_points(out_t)[0], _points(out_j)[0])


def _same_scan(out_t, out_j):
    from scipy.spatial import cKDTree

    xt, xj = _points(out_t)[0], _points(out_j)[0]
    assert abs(len(xt) - len(xj)) <= 0.01 * len(xj) and len(xj) > 500
    d, _ = cKDTree(xj).query(xt)
    assert np.mean(d <= 1e-5) >= 0.99


@pytest.mark.parametrize("tool,args", [
    ("virtual_scanner", ["-n_views", "3", "-resolution", "40", "-dense_samples", "20000"]),
    ("mesh2pcd", ["-n_views", "4", "-resolution", "32", "-dense_samples", "15000"]),
])
def test_scanners_match_jax(tool, args, files, tmp_path):
    t_mod, j_mod = _tools(tool)
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_mod.main([files["mesh_obj"], out_t, *args, *CPU]) == 0
    assert j_mod.main([files["mesh_obj"], out_j, *args]) == 0
    _same_scan(out_t, out_j)
