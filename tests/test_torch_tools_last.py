"""The port's last 25 command-line tools on the CPU (``--device cpu``), each
beside the JAX package's tool on files the test writes.

- The file tools (``plyheader``, ``pcd_convert_NaN_nan``, ``ply2raw``,
  ``convert_pcd_ascii_binary``, ``converter``, ``pcd_change_viewpoint``,
  ``transform_from_viewpoint``) print the same lines and write the same
  bytes.
- ``pcd_introduce_nan`` draws with numpy's ``default_rng(seed)`` in both
  packages: the same bytes. ``add_gaussian_noise``'s core is fed the JAX
  draw (ROADMAP C17): the same bytes; its sampler is checked by its
  statistics. ``demean_cloud`` subtracts a centroid summed in another order:
  points to 1e-6 of their scale.
- The filters write the same bytes, but for the bilateral filters (weighted
  sums in another order: 1e-5 of the scale) and ``plane_projection`` (the
  JAX draws fed to ``ransac_core``: coefficients to 1e-5, points to 1e-5).
- ``extract_feature``: normals within 1e-5 of each other (ROADMAP C9); each
  descriptor of the port's file is the port's function on the port's own
  normals, and the port's function on the JAX package's normals gives the
  JAX file's rows to 1e-3 on 95% of them (FPFH's and PFH's bin flips, C19);
  ESF on the JAX draws (C50) to its bin-edge allowance. The unary
  classifier trains on the JAX k-means draws (C61) and labels alike.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
from pcl_tpu import io as jio
from pcl_tpu import features as jfeat
from pcl_tpu.search import bruteforce as jbf
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.tools import (add_gaussian_noise as j_noise, bilateral_upsampling as j_bup,
                           cluster_extraction as j_clusters,
                           convert_pcd_ascii_binary as j_convert_pcd, converter as j_converter,
                           demean_cloud as j_demean, extract_feature as j_feature,
                           fast_bilateral_filter as j_fbf, grid_min as j_grid_min,
                           local_max as j_local_max, morph as j_morph,
                           outlier_removal as j_outliers, passthrough_filter as j_pass,
                           pcd_change_viewpoint as j_viewpoint, pcd_convert_NaN_nan as j_nan,
                           pcd_introduce_nan as j_intro_nan, plane_projection as j_plane,
                           ply2raw as j_ply2raw, plyheader as j_plyheader,
                           progressive_morphological_filter as j_pmf,
                           radius_filter as j_radius, train_unary_classifier as j_train,
                           transform_from_viewpoint as j_from_vp,
                           unary_classifier_segment as j_segment,
                           uniform_sampling as j_uniform)

from pcl_tpu_torch import features as tfeat
from pcl_tpu_torch import io as tio
from pcl_tpu_torch import sac as tsac
from pcl_tpu_torch.core.cloud import Cloud, to_numpy
from pcl_tpu_torch.features.global_desc import estimate_esf_core
from pcl_tpu_torch.tools import (add_gaussian_noise as t_noise, bilateral_upsampling as t_bup,
                                 cluster_extraction as t_clusters,
                                 convert_pcd_ascii_binary as t_convert_pcd,
                                 converter as t_converter, demean_cloud as t_demean,
                                 extract_feature as t_feature, fast_bilateral_filter as t_fbf,
                                 grid_min as t_grid_min, local_max as t_local_max,
                                 morph as t_morph, outlier_removal as t_outliers,
                                 passthrough_filter as t_pass,
                                 pcd_change_viewpoint as t_viewpoint,
                                 pcd_convert_NaN_nan as t_nan,
                                 pcd_introduce_nan as t_intro_nan, plane_projection as t_plane,
                                 ply2raw as t_ply2raw, plyheader as t_plyheader,
                                 progressive_morphological_filter as t_pmf,
                                 radius_filter as t_radius, train_unary_classifier as t_train,
                                 transform_from_viewpoint as t_from_vp,
                                 unary_classifier_segment as t_segment,
                                 uniform_sampling as t_uniform)

CPU = ["--device", "cpu"]


def street(rng, n=1600):
    """Ground (z up, a gentle slope and 1 cm noise), two boxes, a facade and
    a pole: 1 m cells see ground, objects and walls."""
    k = n // 8
    g = rng.uniform(-8, 8, (5 * k, 2))
    ground = np.column_stack([g, 0.02 * g[:, 0] + rng.normal(0, 0.01, len(g))])
    box = lambda c, m: np.column_stack([rng.uniform(c[0] - 1, c[0] + 1, m),   # noqa: E731
                                        rng.uniform(c[1] - 0.8, c[1] + 0.8, m),
                                        rng.uniform(0.2, 1.5, m)])
    facade = np.column_stack([np.full(k, 8.5) + rng.normal(0, 0.01, k), rng.uniform(-8, 8, k),
                              rng.uniform(0, 5, k)])
    t = rng.uniform(0, 4, n - 7 * k)
    pole = np.column_stack([-3 + 0.05 * np.cos(7 * t), 4 + 0.05 * np.sin(7 * t), t])
    return np.concatenate([ground, box((2, -3), k // 2), box((-4, -1), k // 2), facade,
                           pole]).astype(np.float32)


def frame(rng, H=24, W=32, rgb=True):
    """An organized depth frame: a tilted plane 2 m away and a box 0.5 m in
    front of it, 5% of the pixels without a return (zero points)."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    f = 30.0
    z = 2.0 + 0.01 * u + rng.normal(0, 0.003, (H, W))
    box = (abs(u - W / 2) < 5) & (abs(v - H / 2) < 4)
    z = np.where(box, z - 0.5, z).astype(np.float32)
    z[rng.random((H, W)) < 0.05] = 0.0
    xyz = np.stack([(u - W / 2) * z / f, (v - H / 2) * z / f, z], -1).reshape(-1, 3)
    attrs = {}
    if rgb:
        col = np.where(box[..., None], [0.8, 0.2, 0.1], [0.3, 0.5, 0.7])
        attrs["rgb"] = torch.from_numpy((col + rng.normal(0, 0.02, col.shape)).clip(0, 1)
                                        .astype(np.float32).reshape(-1, 3))
    return Cloud(xyz=torch.from_numpy(xyz.astype(np.float32)),
                 mask=torch.ones(H * W, dtype=torch.bool), attrs=attrs, width=W, height=H)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(16)
    d = tmp_path_factory.mktemp("last_tools")
    pts = street(rng)
    out = {"dir": d}
    c = Cloud(xyz=torch.from_numpy(pts), mask=torch.ones(len(pts), dtype=torch.bool),
              attrs={"intensity": torch.from_numpy(rng.random(len(pts)).astype(np.float32))})
    out["street"] = str(d / "street.pcd")
    tio.save(out["street"], c, data="binary")
    out["street_ascii"] = str(d / "street_ascii.pcd")
    tio.save(out["street_ascii"], c, data="ascii",
             viewpoint=(1.0, -2.0, 0.5, 0.9238795, 0.0, 0.3826834, 0.0))
    out["frame"] = str(d / "frame.pcd")
    tio.save(out["frame"], frame(rng), data="binary")
    out["frame_grey"] = str(d / "frame_grey.pcd")
    tio.save(out["frame_grey"], frame(rng, rgb=False), data="binary")
    # a mesh: a 6 x 5 grid of vertices in two triangles a cell
    gu, gv = np.meshgrid(np.arange(6, dtype=np.float32), np.arange(5, dtype=np.float32))
    verts = np.column_stack([gu.ravel() * 0.1, gv.ravel() * 0.1,
                             0.01 * gu.ravel() * gv.ravel()]).astype(np.float32)
    quads = [(r * 6 + k, r * 6 + k + 1, (r + 1) * 6 + k) for r in range(4) for k in range(5)]
    quads += [(r * 6 + k + 1, (r + 1) * 6 + k + 1, (r + 1) * 6 + k) for r in range(4)
              for k in range(5)]
    mesh = Cloud(xyz=torch.from_numpy(verts), mask=torch.ones(len(verts), dtype=torch.bool))
    for name, binary in (("mesh_ascii.ply", False), ("mesh_binary.ply", True)):
        out[name] = str(d / name)
        tio.save_ply(out[name], mesh, binary=binary, faces=np.asarray(quads, np.int32))
    # an ascii PCD as old writers spelled NaN
    text = open(out["street_ascii"]).read().split("\n")
    head = [i for i, ln in enumerate(text) if ln.startswith("DATA")][0] + 1
    for i in range(head + 3, head + 40, 5):
        text[i] = "NaN NaN NaN " + text[i].split(" ", 3)[3]
    out["nan_ascii"] = str(d / "nan_ascii.pcd")
    with open(out["nan_ascii"], "w") as f:
        f.write("\n".join(text))
    return out


NO_DEVICE = (t_plyheader, t_nan)         # they read and write bytes: no cloud, no device


def _run(capsys, t_tool, j_tool, t_argv, j_argv):
    """Both tools, each with its own output names; returns their stdout."""
    assert t_tool.main([*t_argv, *([] if t_tool in NO_DEVICE else CPU)]) == 0
    out_t = capsys.readouterr().out
    assert j_tool.main(j_argv) == 0
    return out_t, capsys.readouterr().out


def _bytes(path):
    """A file's bytes; a PLY file's writer comment (``generated by pcl_tpu``
    or ``pcl_tpu_torch``) is left out."""
    with open(path, "rb") as f:
        data = f.read()
    return re.sub(rb"comment generated by pcl_tpu(_torch)?\n", b"", data, count=1) \
        if data.startswith(b"ply\n") else data


def _pair(files, capsys, t_tool, j_tool, src, args=(), ext=".pcd", same_line=True):
    d = files["dir"]
    name = t_tool.__name__.split(".")[-1] + "_" + "_".join(a.strip("-") for a in args)
    ot, oj = str(d / f"{name}_t{ext}"), str(d / f"{name}_j{ext}")
    lt, lj = _run(capsys, t_tool, j_tool, [files[src], ot, *args], [files[src], oj, *args])
    lt, lj = lt.replace(ot, "OUT"), lj.replace(oj, "OUT")
    if same_line:
        assert lt == lj
    return ot, oj, lt


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mesh_ascii.ply", "mesh_binary.ply"])
def test_plyheader_prints_the_jax_header(files, capsys, name):
    lt, lj = _run(capsys, t_plyheader, j_plyheader, [files[name]], [files[name]])
    assert lt == lj and lt.strip().endswith("end_header") and "element face 40" in lt


def test_pcd_convert_nan_writes_the_jax_bytes(files, capsys):
    ot, oj, line = _pair(files, capsys, t_nan, j_nan, "nan_ascii")
    assert _bytes(ot) == _bytes(oj) and line.startswith("[pcd_convert_NaN_nan] 24 ")
    assert b"NaN" not in _bytes(ot)


@pytest.mark.parametrize("name", ["mesh_ascii.ply", "mesh_binary.ply"])
def test_ply2raw_writes_the_jax_triangles(files, capsys, name):
    ot, oj, line = _pair(files, capsys, t_ply2raw, j_ply2raw, name, (), ".raw")
    assert _bytes(ot) == _bytes(oj) and "(40 triangles)" in line


@pytest.mark.parametrize("mode", ["0", "1", "2", "binary_compressed"])
def test_convert_pcd_ascii_binary_writes_the_jax_bytes(files, capsys, mode):
    ot, oj, line = _pair(files, capsys, t_convert_pcd, j_convert_pcd, "street", (mode,))
    assert _bytes(ot) == _bytes(oj) and "1600 points" in line


@pytest.mark.parametrize("src,ext,fmt", [("street", ".ply", "ascii"), ("street", ".ply", "binary"),
                                         ("mesh_binary.ply", ".pcd", "binary_compressed"),
                                         ("street_ascii", ".pcd", "ascii")])
def test_converter_writes_the_jax_bytes(files, capsys, src, ext, fmt):
    d = files["dir"]
    ot, oj = str(d / f"conv_{src}_{fmt}_t{ext}"), str(d / f"conv_{src}_{fmt}_j{ext}")
    lt, lj = _run(capsys, t_converter, j_converter, [files[src], ot, "-f", fmt],
                  [files[src], oj, "-f", fmt])
    assert lt.replace(ot, "OUT") == lj.replace(oj, "OUT")
    assert _bytes(ot) == _bytes(oj)


def test_pcd_change_viewpoint_writes_the_jax_bytes(files, capsys):
    vp = ["0.5", "-1", "2", "0.7071068", "0", "0", "0.7071068"]
    ot, oj, line = _pair(files, capsys, t_viewpoint, j_viewpoint, "street", vp)
    assert _bytes(ot) == _bytes(oj)
    vp_line = [ln for ln in _bytes(ot).split(b"\n") if ln.startswith(b"VIEWPOINT")][0]
    np.testing.assert_allclose([float(v) for v in vp_line.split()[1:]], [float(v) for v in vp],
                               atol=1e-6)


@pytest.mark.parametrize("inverse", [[], ["--inverse"]], ids=["forward", "inverse"])
def test_transform_from_viewpoint_writes_the_jax_bytes(files, capsys, inverse):
    ot, oj, _ = _pair(files, capsys, t_from_vp, j_from_vp, "street_ascii", inverse)
    assert _bytes(ot) == _bytes(oj)


# ---------------------------------------------------------------------------
# Per-point edits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [[], ["-fraction", "0.3", "-seed", "5"]], ids=["default", "f03"])
def test_pcd_introduce_nan_writes_the_jax_bytes(files, capsys, args):
    ot, oj, line = _pair(files, capsys, t_intro_nan, j_intro_nan, "street", args)
    assert _bytes(ot) == _bytes(oj) and b"nan" in _bytes(ot)


def test_demean_cloud_matches_jax(files, capsys):
    ot, oj, line = _pair(files, capsys, t_demean, j_demean, "street", same_line=False)
    (xt, _), (xj, _) = to_numpy(tio.load(ot, device="cpu")), to_numpy(tio.load(oj, device="cpu"))
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6 * 10)
    assert np.abs(xt.mean(0)).max() < 1e-5


@pytest.mark.parametrize("sd,seed", [(0.01, 0), (0.2, 3)])
def test_add_gaussian_noise_core_writes_the_jax_bytes(files, capsys, sd, seed):
    """The JAX tool's draw, ``normal(PRNGKey(seed)) * sd``, fed to the core."""
    c = jio.load(files["street"])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(seed), c.xyz.shape) * sd)
    d = files["dir"]
    ot, oj = str(d / f"noise{seed}_t.pcd"), str(d / f"noise{seed}_j.pcd")
    args = ["-sd", str(sd), "-seed", str(seed)]
    assert t_noise.main([files["street"], ot, *args, *CPU], noise=noise) == 0
    lt = capsys.readouterr().out
    assert j_noise.main([files["street"], oj, *args]) == 0
    assert lt == capsys.readouterr().out
    assert _bytes(ot) == _bytes(oj)


def test_add_gaussian_noise_sampler(files, capsys, tmp_path):
    """The sampler's own draw: seeded (the same file twice), zero mean and the
    asked spread within their sampling error, each valid point moved."""
    c = tio.load(files["street"], device="cpu")
    paths = [str(tmp_path / f"n{i}.pcd") for i in range(3)]
    for p, seed in zip(paths, (7, 7, 8)):
        assert t_noise.main([files["street"], p, "-sd", "0.05", "-seed", str(seed), *CPU]) == 0
    capsys.readouterr()
    a, b, e = (to_numpy(tio.load(p, device="cpu"))[0] for p in paths)
    assert np.array_equal(a, b) and not np.array_equal(a, e)
    n = a - to_numpy(c)[0]
    assert abs(n.mean()) < 4 * 0.05 / np.sqrt(n.size)
    assert abs(n.std() / 0.05 - 1) < 0.05 and (np.abs(n).max(1) > 0).all()
    drawn = t_noise.draw_noise(c, 0.05, 7)
    assert drawn.device == c.xyz.device and drawn.dtype == torch.float32


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

FILTER_CASES = [
    (t_pass, j_pass, ["-field", "z", "-min", "0.1", "-max", "2.0"]),
    (t_pass, j_pass, ["-field", "x", "-min", "-2", "-max", "3", "--negative"]),
    (t_uniform, j_uniform, ["-radius", "0.5"]),
    (t_radius, j_radius, ["-radius", "0.6", "-min_neighbors", "4"]),
    (t_outliers, j_outliers, ["-mean_k", "8", "-std_dev_mul", "1.0"]),
    (t_outliers, j_outliers, ["-method", "radius", "-radius", "0.5", "-min_pts", "3"]),
    (t_grid_min, j_grid_min, ["-resolution", "1.0"]),
    (t_local_max, j_local_max, ["-radius", "1.0"]),
    (t_morph, j_morph, []),
    (t_morph, j_morph, ["-operator", "erode", "-resolution", "0.5"]),
    (t_morph, j_morph, ["-operator", "dilate"]),
    (t_morph, j_morph, ["-operator", "close", "-resolution", "2.0"]),
    (t_pmf, j_pmf, ["-max_window", "9", "-initial_distance", "0.3"]),
    (t_pmf, j_pmf, ["--extract_negative"]),
]


@pytest.mark.parametrize("t_tool,j_tool,args", FILTER_CASES,
                         ids=[t.__name__.split(".")[-1] + "-" + ("_".join(a.strip("-") for a in a_)
                                                                 or "default")
                              for t, _, a_ in FILTER_CASES])
def test_filters_write_the_jax_bytes(files, capsys, t_tool, j_tool, args):
    ot, oj, line = _pair(files, capsys, t_tool, j_tool, "street", args)
    assert _bytes(ot) == _bytes(oj)
    if t_tool is not t_morph:
        assert 0 < int(re.search(r"\d+ -> (\d+)", line).group(1)) < 1600, line


def test_uniform_sampling_keeps_input_points(files, capsys):
    ot, _, _ = _pair(files, capsys, t_uniform, j_uniform, "street", ["-radius", "0.7"])
    kept = to_numpy(tio.load(ot, device="cpu"))[0]
    pts = to_numpy(tio.load(files["street"], device="cpu"))[0]
    cells = np.floor(kept / np.float32(0.7)).astype(np.int64)
    assert len(np.unique(cells, axis=0)) == len(kept)
    assert len(np.unique(np.floor(pts / np.float32(0.7)).astype(np.int64), axis=0)) == len(kept)
    assert (np.abs(kept[:, None, :] - pts[None]).max(-1).min(1) == 0).all()


def _close_files(ot, oj, atol):
    a, b = tio.load(ot, device="cpu"), tio.load(oj, device="cpu")
    np.testing.assert_array_equal(a.mask.numpy(), b.mask.numpy())
    assert (a.width, a.height) == (b.width, b.height)
    np.testing.assert_allclose(a.xyz.numpy(), b.xyz.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("src,args", [("frame", []), ("frame", ["-sigma_s", "3", "-sigma_r", "0.2"]),
                                      ("street", ["-sigma_s", "0.3", "-sigma_r", "0.3"])],
                         ids=["organized", "organized_wide", "unorganized"])
def test_fast_bilateral_filter_matches_jax(files, capsys, src, args):
    ot, oj, _ = _pair(files, capsys, t_fbf, j_fbf, src, args)
    _close_files(ot, oj, 1e-5 * 10)


@pytest.mark.parametrize("src,args", [("frame", []), ("frame_grey", ["-window", "3"])],
                         ids=["rgb", "grey"])
def test_bilateral_upsampling_matches_jax(files, capsys, src, args):
    ot, oj, _ = _pair(files, capsys, t_bup, j_bup, src, args)
    _close_files(ot, oj, 1e-5 * 3)


def _jax_ransac_draws(mask, n_hyp=1024, m=3, frac=0.1):
    """The indices and subset ``pcl_tpu.sac.ransac`` draws from its default
    key, ``PRNGKey(0)`` (``sac/ransac.py:102-113``)."""
    jransac = importlib.import_module("pcl_tpu.sac.ransac")
    n = len(mask)
    w = jnp.asarray(mask).astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    k_idx, k_sub = jax.random.split(jax.random.PRNGKey(0))
    idx = jransac._sample_indices(k_idx, n_hyp, m, n, probs)
    sub = jax.random.bernoulli(k_sub, frac, (n,)) & jnp.asarray(mask)
    return torch.from_numpy(np.asarray(idx)), torch.from_numpy(np.asarray(sub))


def _plane(line):
    return np.array([float(v) for v in re.search(r"plane \[([^\]]*)\]", line).group(1).split()])


def test_plane_projection_on_the_jax_draws(files, capsys):
    d = files["dir"]
    ot, oj = str(d / "plane_t.pcd"), str(d / "plane_j.pcd")
    mask = tio.load(files["street"], device="cpu").mask.numpy()
    args = ["-thresh", "0.05"]
    assert t_plane.main([files["street"], ot, *args, *CPU], draws=_jax_ransac_draws(mask)) == 0
    lt = capsys.readouterr().out.splitlines()
    assert j_plane.main([files["street"], oj, *args]) == 0
    lj = capsys.readouterr().out.splitlines()
    np.testing.assert_allclose(_plane(lt[0]), _plane(lj[0]), atol=1e-5)
    assert lt[0].split("(")[1] == lj[0].split("(")[1] and lt[1] == lj[1]
    _close_files(ot, oj, 1e-5 * 10)
    xt = to_numpy(tio.load(ot, device="cpu"))[0]
    assert np.abs(xt[:, 2] - 0.02 * xt[:, 0]).max() < 0.02      # on the ground plane


def test_plane_projection_on_its_own_draws_and_given_coeffs(files, capsys):
    d = files["dir"]
    ot, oj = str(d / "own_t.pcd"), str(d / "own_j.pcd")
    lt, lj = _run(capsys, t_plane, j_plane, [files["street"], ot, "-thresh", "0.05"],
                  [files["street"], oj, "-thresh", "0.05"])
    np.testing.assert_allclose(_plane(lt), _plane(lj), atol=2e-3)
    coeffs = ["-coeffs", "0.1,0.2,0.97,-0.5"]
    ot, oj, _ = _pair(files, capsys, t_plane, j_plane, "street", coeffs)
    _close_files(ot, oj, 1e-5 * 10)


# ---------------------------------------------------------------------------
# Segmentation and features
# ---------------------------------------------------------------------------

def test_cluster_extraction_writes_the_jax_clusters(files, capsys):
    d = files["dir"]
    args = ["-tolerance", "0.35", "-min_size", "30"]
    lt, lj = _run(capsys, t_clusters, j_clusters,
                  [files["street"], *args, "--write", "-prefix", str(d / "ct_")],
                  [files["street"], *args, "--write", "-prefix", str(d / "cj_")])
    assert lt == lj
    n = int(lt.split()[1])
    assert n >= 4
    for i in range(n):
        assert _bytes(str(d / f"ct_{i}.pcd")) == _bytes(str(d / f"cj_{i}.pcd"))
    assert not os.path.exists(str(d / f"ct_{n}.pcd"))


@pytest.fixture(scope="module")
def normals(files):
    """Each package's normals of the street at the tool's k (16)."""
    jc = jfeat.estimate_normals(jio.load(files["street"]), k=16)
    tc = tfeat.estimate_normals(tio.load(files["street"], device="cpu"), k=16)
    return jc, tc


def _with_normals(tc, jc):
    return tc.with_attrs(normal=torch.from_numpy(np.asarray(jc.attrs["normal"])))


@pytest.mark.parametrize("feature", ["normal", "pfh", "fpfh", "vfh", "shot"])
def test_extract_feature_matches_jax(files, capsys, normals, feature):
    jc, tc = normals
    args = ["-feature", feature, "-k", "16", "-radius", "0.6"]
    ot, oj, _ = _pair(files, capsys, t_feature, j_feature, "street", args, ".npy")
    t, j = np.load(ot), np.load(oj)
    assert t.shape == j.shape
    if feature == "normal":
        assert ((t * j).sum(1) >= 1 - 1e-5).all()
        return
    fns = {"pfh": lambda c: tfeat.estimate_pfh(c, k=16),
           "fpfh": lambda c: tfeat.estimate_fpfh(c, k=16),
           "vfh": lambda c: tfeat.estimate_vfh(c)[None],
           "shot": lambda c: tfeat.estimate_shot(c, radius=0.6, k=16)}
    own = fns[feature](tc).numpy()
    np.testing.assert_array_equal(t, own[tc.mask.numpy()] if own.shape[0] == tc.capacity
                                  else own)
    from_j = fns[feature](_with_normals(tc, jc)).numpy()
    from_j = from_j[tc.mask.numpy()] if from_j.shape[0] == tc.capacity else from_j
    if feature == "fpfh":
        # C19: the rows none of whose pairs lies within 1e-5 of a bin edge
        idx, _, valid = jbf.knn(jc.xyz, jc.mask, jc.xyz, 16)
        valid = np.asarray(valid & jc.mask[:, None])
        spfh = F.spfh_firm(np.asarray(jc.xyz), np.asarray(jc.attrs["normal"]),
                           np.asarray(idx), valid)
        firm = F.fpfh_firm(spfh, np.asarray(idx), valid)[np.asarray(jc.mask)]
        assert firm.mean() > 0.5
        np.testing.assert_allclose(from_j[firm], j[firm], rtol=0, atol=1e-3)
        return
    assert (np.abs(from_j - j).max(1) <= 1e-3 * max(1.0, np.abs(j).max())).mean() >= 0.95


def test_extract_feature_esf_on_the_jax_draws(files, capsys):
    """ESF's draws from ``PRNGKey(0)`` (``global_desc.py:83-93``) fed to the
    port; a sample whose shape function lies within 1e-5 of a bin edge may
    move 100/4096 of a bin, counted as in ``test_torch_global_desc.py``."""
    jc = jio.load(files["street"])
    probs = np.asarray(jc.mask).astype(np.float32)
    probs = jnp.asarray(probs / max(probs.sum(), 1.0))
    tri = np.stack([np.asarray(jax.random.categorical(
        k, jnp.log(probs + 1e-30)[None, :].repeat(4096, 0)))
        for k in jax.random.split(jax.random.PRNGKey(0), 3)])
    d = files["dir"]
    ot, oj = str(d / "esf_t.npy"), str(d / "esf_j.npy")
    assert t_feature.main([files["street"], ot, "-feature", "esf", *CPU],
                          esf_draws=torch.from_numpy(tri)) == 0
    lt = capsys.readouterr().out
    assert j_feature.main([files["street"], oj, "-feature", "esf"]) == 0
    assert lt.replace("_t.npy", "") == capsys.readouterr().out.replace("_j.npy", "")
    t, j = np.load(ot), np.load(oj)
    assert t.shape == j.shape == (1, 640)
    x = np.asarray(jc.xyz, np.float64)
    m = np.asarray(jc.mask)
    scale = np.max(np.linalg.norm(np.where(m[:, None], x, 0) - x.mean(0), axis=1))
    a, b, c = x[tri[0]], x[tri[1]], x[tri[2]]
    dd = [np.linalg.norm(p - q, axis=1) / (2 * scale) for p, q in ((a, b), (b, c), (c, a))]
    near = sum((np.abs(v * 64 - np.round(v * 64)) <= 1e-5 * 64)
               for v in dd + [(dd[0] + dd[1] + dd[2]) / 3])
    assert np.abs(t - j).max() <= 1e-4 + 2 * 100.0 / 4096 * int((near > 0).sum())
    own = np.load(ot)
    np.testing.assert_array_equal(
        own[0], estimate_esf_core(tio.load(files["street"], device="cpu"),
                                  torch.from_numpy(tri)).numpy())


@pytest.fixture(scope="module")
def classes(files):
    """Ground and non-ground of the street as two class files."""
    c = tio.load(files["street"], device="cpu")
    ground = c.xyz[:, 2].abs() < 0.2 + 0.02 * c.xyz[:, 0].abs()
    paths = []
    for name, sel in (("ground", ground), ("objects", ~ground)):
        p = str(files["dir"] / f"class_{name}.pcd")
        tio.save(p, c.with_mask(sel), data="binary")
        paths.append(p)
    return paths


def test_unary_classifier_tools_on_the_jax_draws(files, capsys, classes):
    """Training on the JAX k-means draws (PRNGKey(0) a class): the same
    codebook to 1e-4 of its scale and the same labels on the street."""
    d = files["dir"]
    args = ["-clusters", "4", "-k", "16", "-fpfh_k", "16"]
    init = []
    for p in classes:
        n = int(jio.load(p).count)
        init.append(np.array(jax.random.categorical(
            jax.random.PRNGKey(0), jnp.log(jnp.ones(n) / n + 1e-30)[None, :].repeat(4, 0))))
    bt, bj = str(d / "book_t.npz"), str(d / "book_j.npz")
    assert t_train.main([*classes, "-o", bt, *args, *CPU], init_indices=init) == 0
    lt = capsys.readouterr().out
    assert j_train.main([*classes, "-o", bj, *args]) == 0
    assert lt == capsys.readouterr().out == "[train_unary_classifier] 2 classes -> 8 centroids\n"
    zt, zj = np.load(bt), np.load(bj)
    np.testing.assert_array_equal(zt["class_of"], zj["class_of"])
    scale = np.abs(zj["centroids"]).max()
    # FPFH bins flip with the normals (C19): centroids agree as means of
    # nearly the same rows
    np.testing.assert_allclose(zt["centroids"], zj["centroids"], rtol=0, atol=0.05 * scale)
    ot, oj = str(d / "labels_t.pcd"), str(d / "labels_j.pcd")
    lt, lj = _run(capsys, t_segment, j_segment, [files["street"], bj, ot, "-k", "16"],
                  [files["street"], bj, oj, "-k", "16"])
    counts_t, counts_j = (eval(ln.split("] ", 1)[1]) for ln in (lt, lj))
    assert set(counts_t) == set(counts_j) == {0, 1}
    lab_t = tio.load(ot, device="cpu").attrs["label"].numpy()
    lab_j = tio.load(oj, device="cpu").attrs["label"].numpy()
    assert (lab_t == lab_j).mean() >= 0.95
    # the port's file holds the port's own labels of its own FPFH
    tc = tfeat.estimate_normals(tio.load(files["street"], device="cpu"), k=16)
    from pcl_tpu_torch.segmentation.advanced import UnaryClassifier
    clf = UnaryClassifier()
    clf.centroids, clf.class_of = np.load(bj)["centroids"], np.load(bj)["class_of"]
    own = clf.segment(tfeat.estimate_fpfh(tc, k=16).numpy())
    np.testing.assert_array_equal(lab_t, own[tc.mask.numpy()])


# ---------------------------------------------------------------------------
# The card by default
# ---------------------------------------------------------------------------

CARD_TOOLS = [t_ply2raw, t_convert_pcd, t_converter, t_viewpoint, t_from_vp, t_intro_nan,
              t_demean, t_noise, t_pass, t_uniform, t_radius, t_outliers, t_grid_min,
              t_local_max, t_morph, t_pmf, t_fbf, t_bup, t_plane, t_clusters, t_feature,
              t_train, t_segment]


@pytest.mark.parametrize("tool", CARD_TOOLS, ids=lambda m: m.__name__.split(".")[-1])
def test_tools_ask_for_the_card_by_default(files, monkeypatch, tmp_path, tool):
    """No silent move to the CPU: without a card and without --device cpu the
    tool fails with the error the first constructor raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o.pcd")
    argv = {t_ply2raw: [files["mesh_binary.ply"], out], t_convert_pcd: [files["street"], out, "1"],
            t_viewpoint: [files["street"], out, *["0"] * 6, "1"],
            t_bup: [files["frame"], out], t_fbf: [files["frame"], out],
            t_clusters: [files["street"]], t_feature: [files["street"], str(tmp_path / "o.npy")],
            t_train: [files["street"], "-o", str(tmp_path / "b.npz")],
            t_segment: [files["street"], str(tmp_path / "b.npz"), out]}.get(
        tool, [files["street"], out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def test_the_file_tools_need_no_device(files, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_plyheader.main([files["mesh_binary.ply"]]) == 0
    assert t_nan.main([files["nan_ascii"], str(tmp_path / "o.pcd")]) == 0
    capsys.readouterr()
