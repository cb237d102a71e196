"""The port's command-line tools on the CPU (``--device cpu``), on files the
test writes, beside the JAX package's tools on the same files.

Poses of ``tools.odometry`` agree within 1e-3 m and 1e-3 in rotation entries
(both run float32 loops whose 1-NN distances differ in rounding, ROADMAP C1;
NDT's runs may take other iterates to the same optimum); the downsampled and
normal-estimated files hold the same points."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest
import torch

from pcl_tpu.tools import fpfh_estimation as j_fpfh
from pcl_tpu.tools import elch as j_elch
from pcl_tpu.tools import icp as j_icp
from pcl_tpu.tools import lum as j_lum
from pcl_tpu.tools import ndt3d as j_ndt3d
from pcl_tpu.tools import normal_estimation as j_normals
from pcl_tpu.tools import odometry as j_odometry
from pcl_tpu.tools import sac_segmentation as j_sacseg
from pcl_tpu.tools import sac_segmentation_plane as j_sacplane
from pcl_tpu.tools import voxel_grid as j_voxel_grid
from pcl_tpu.tools import compute_cloud_error as j_cloud_error
from pcl_tpu.tools import compute_hausdorff as j_hausdorff
from pcl_tpu.tools import icp2d as j_icp2d
from pcl_tpu.tools import iterative_closest_point as j_iter_icp
from pcl_tpu.tools import ndt2d as j_ndt2d
from pcl_tpu.tools import boundary_estimation as j_boundary
from pcl_tpu.tools import spin_estimation as j_spin
from pcl_tpu.tools import vfh_estimation as j_vfh
from pcl_tpu.tools import compute_hull as j_hull
from pcl_tpu.tools import crop_to_hull as j_crop
from pcl_tpu.tools import gp3_surface as j_gp3
from pcl_tpu.tools import marching_cubes_reconstruction as j_mc
from pcl_tpu.tools import mls_smoothing as j_mls
from pcl_tpu.tools import poisson_reconstruction as j_poisson

from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core.cloud import make_cloud, to_numpy
from pcl_tpu_torch.registration import trajectory as ttraj
from pcl_tpu_torch.tools import fpfh_estimation as t_fpfh
from pcl_tpu_torch.tools import elch as t_elch
from pcl_tpu_torch.tools import icp as t_icp
from pcl_tpu_torch.tools import lum as t_lum
from pcl_tpu_torch.tools import ndt3d as t_ndt3d
from pcl_tpu_torch.tools import normal_estimation as t_normals
from pcl_tpu_torch.tools import odometry as t_odometry
from pcl_tpu_torch.tools import sac_segmentation as t_sacseg
from pcl_tpu_torch.tools import sac_segmentation_plane as t_sacplane
from pcl_tpu_torch.tools import voxel_grid as t_voxel_grid
from pcl_tpu_torch.tools import compute_cloud_error as t_cloud_error
from pcl_tpu_torch.tools import compute_hausdorff as t_hausdorff
from pcl_tpu_torch.tools import icp2d as t_icp2d
from pcl_tpu_torch.tools import iterative_closest_point as t_iter_icp
from pcl_tpu_torch.tools import ndt2d as t_ndt2d
from pcl_tpu_torch.tools import boundary_estimation as t_boundary
from pcl_tpu_torch.tools import spin_estimation as t_spin
from pcl_tpu_torch.tools import vfh_estimation as t_vfh
from pcl_tpu_torch.tools import compute_hull as t_hull
from pcl_tpu_torch.tools import crop_to_hull as t_crop
from pcl_tpu_torch.tools import gp3_surface as t_gp3
from pcl_tpu_torch.tools import marching_cubes_reconstruction as t_mc
from pcl_tpu_torch.tools import mls_smoothing as t_mls
from pcl_tpu_torch.tools import poisson_reconstruction as t_poisson

CPU = ["--device", "cpu"]


def _room(rng, n):
    """Floor, two walls and a curved sheet: structure on every axis."""
    n1 = n // 4
    u = lambda lo, hi, m: rng.uniform(lo, hi, m)                # noqa: E731
    floor = np.stack([u(-2, 2, n1), np.zeros(n1), u(2, 6, n1)], 1)
    left = np.stack([np.full(n1, -2.0), u(0, 2, n1), u(2, 6, n1)], 1)
    back = np.stack([u(-2, 2, n1), u(0, 2, n1), np.full(n1, 6.0)], 1)
    t = rng.uniform(-1, 1, size=(n - 3 * n1, 2))
    sheet = np.stack([t[:, 0], 0.8 + 0.3 * np.sin(2 * t[:, 0]), 4 + t[:, 1]], 1)
    return np.concatenate([floor, left, back, sheet])


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Three 1500-point scans of a room along a short walk, as PCD files, and
    their golden poses in KITTI format."""
    root = tmp_path_factory.mktemp("scans")
    rng = np.random.default_rng(21)
    pts, golden = ttraj.make_virtual_scan_sequence(
        _room(rng, 6000), 3, np.random.default_rng(22), step_translation=0.05,
        step_rotation=0.02, fov_tan=1.5, z_range=(0.3, 9.0), max_points=1500, noise=0.003)
    files = []
    for i, p in enumerate(pts):
        files.append(str(root / f"scan{i}.pcd"))
        tio.save(files[-1], make_cloud(p, device="cpu"), data="binary_compressed")
    t_odometry._save_poses(str(root / "golden.txt"), golden)
    return files, str(root / "golden.txt"), golden, root


@pytest.mark.parametrize("method,gate", [("gicp", 0.5), ("icp", 0.5), ("gicp", float("inf"))])
def test_probed_cells(scans, method, gate):
    """The cell-list arguments the odometry tool gives its aligner: caps that
    hold the fullest bucket of the tables the aligner builds, covariance cells
    for GICP only, no correspondence cap without a gate."""
    from pcl_tpu_torch import search
    from pcl_tpu_torch.search import cell_list

    s, t = (tio.load(f, device="cpu") for f in scans[0][:2])
    kw = t_odometry.probed_cells(s, t, method, gate)
    assert set(kw) == ({"cell_cap"} if np.isfinite(gate) else set()) | (
        {"cov_cell_size", "cov_cell_cap"} if method == "gicp" else set())
    if np.isfinite(gate):
        table = cell_list.build(t.xyz, t.mask, np.float32(2.0 * gate), cap=kw["cell_cap"])
        assert int(table.count[:-1].max()) <= kw["cell_cap"]
    if method == "gicp":
        assert kw["cov_cell_size"] == max(search.auto_cell_params(c, 20)[0] for c in (s, t))
        for c in (s, t):
            table = cell_list.build(c.xyz, c.mask, np.float32(kw["cov_cell_size"]),
                                    cap=kw["cov_cell_cap"])
            assert int(table.count[:-1].max()) <= kw["cov_cell_cap"]


def _xyz(path):
    return to_numpy(tio.load(path, device="cpu"))


def test_voxel_grid_tool(scans, capsys, tmp_path):
    files = scans[0]
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_voxel_grid.main([files[0], out_t, "-leaf", "0.2", *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_voxel_grid.main([files[0], out_j, "-leaf", "0.2"]) == 0
    assert line_t == capsys.readouterr().out
    assert line_t.startswith("[voxel_grid] 1500 -> ") and "(leaf 0.2)" in line_t
    np.testing.assert_allclose(_xyz(out_t)[0], _xyz(out_j)[0], atol=1e-6)


def test_normal_estimation_tool(scans, capsys, tmp_path):
    files = scans[0]
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    args = ["-k", "12", "-vy", "1.0"]
    assert t_normals.main([files[0], out_t, *args, *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_normals.main([files[0], out_j, *args]) == 0
    assert line_t == capsys.readouterr().out == "[normal_estimation] 1500 points, k=12\n"
    (xt, at), (xj, aj) = _xyz(out_t), _xyz(out_j)
    np.testing.assert_array_equal(xt, xj)
    # normals are signed towards the viewpoint; a few neighbourhoods are
    # ill-conditioned (ROADMAP C9), hence the share
    dots = (at["normal"] * aj["normal"]).sum(1)
    assert (dots > 1 - 1e-4).mean() > 0.99
    assert set(at) == {"normal", "curvature"}


def test_icp_tool(scans, capsys, tmp_path):
    files = scans[0]
    out_t = str(tmp_path / "aligned.pcd")
    args = [files[1], files[0], "--max-corr-dist", "0.5", "--iters", "30"]
    rc_t = t_icp.main([*args, "-o", out_t, *CPU])
    text_t = capsys.readouterr().out
    rc_j = j_icp.main(args)
    text_j = capsys.readouterr().out
    assert rc_t == rc_j == 0
    assert text_t.splitlines()[0] == text_j.splitlines()[0] == \
        "[icp] source: 1500 pts  target: 1500 pts"
    assert "[icp] converged=True iters=" in text_t and f"[icp] wrote {out_t}" in text_t

    def matrix(text):
        rows = [ln.strip(" []") for ln in text.splitlines() if ln.lstrip().startswith("[")
                and "icp" not in ln]
        return np.array([[float(v) for v in r.split()] for r in rows[:4]])

    np.testing.assert_allclose(matrix(text_t), matrix(text_j), atol=1e-3)
    assert _xyz(out_t)[0].shape == (1500, 3)


def test_ndt3d_tool(scans, capsys, tmp_path):
    files = scans[0]
    out_t = str(tmp_path / "aligned.pcd")
    args = [files[1], files[0], "-r", "1.0", "--iters", "30"]
    assert t_ndt3d.main([*args, "-o", out_t, *CPU]) == 0
    text_t = capsys.readouterr().out
    assert j_ndt3d.main(args) == 0
    text_j = capsys.readouterr().out
    head_t, head_j = text_t.splitlines()[0], text_j.splitlines()[0]
    assert head_t.startswith("[ndt3d] converged=True iters=")
    score = lambda h: float(h.split("score=")[1])               # noqa: E731
    assert score(head_t) == pytest.approx(score(head_j), rel=1e-3)
    assert _xyz(out_t)[0].shape == (1500, 3)


@pytest.mark.parametrize("method,extra", [
    ("icp", ["--max-corr-dist", "0.5"]),
    ("icp_p2plane", ["--max-corr-dist", "0.5"]),
    ("gicp", ["--max-corr-dist", "0.5"]),
    ("ndt", ["--resolution", "1.0"]),
])
def test_odometry_tool_matches_jax(scans, capsys, tmp_path, method, extra):
    files, golden_file, golden, _ = scans
    poses_t, poses_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    args = [*files, "--method", method, *extra, "--golden", golden_file]
    assert t_odometry.main([*args, "--poses-out", poses_t, *CPU]) == 0
    cap_t = capsys.readouterr()
    assert j_odometry.main([*args, "--poses-out", poses_j]) == 0
    cap_j = capsys.readouterr()
    assert cap_t.err.splitlines()[0] == cap_j.err.splitlines()[0] == \
        f"[odometry] 3 scans, method={method}"
    assert cap_t.out.startswith("ATE rmse=") and "(unaligned)" in cap_t.out
    got, want = t_odometry._load_poses(poses_t), j_odometry._load_poses(poses_j)
    assert got.shape == (3, 4, 4)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-3)
    ate = float(cap_t.out.split("rmse=")[2].split()[0])
    print(f"{method}: unaligned ATE {ate} m")
    assert ate < (0.05 if method == "ndt" else 0.02)


def test_odometry_tool_default_method_and_length(scans, capsys):
    files = scans[0]
    assert t_odometry.main([*files[:2], "--max-corr-dist", "0.5", *CPU]) == 0
    cap = capsys.readouterr()
    assert "method=gicp" in cap.err and cap.out.startswith("trajectory length: ")
    with pytest.raises(ValueError, match="12 columns"):
        bad = scans[3] / "bad.txt"
        np.savetxt(bad, np.zeros((3, 7)))
        t_odometry._load_poses(str(bad))


def test_fpfh_estimation_tool(scans, capsys, tmp_path):
    """Normals and FPFH of a scan: both tools print the same line and write
    the same points and, to 1e-5, the same normals (ROADMAP C9). FPFH turns
    a normal's 1e-3 rad into flipped bins (ROADMAP C19), so the descriptors
    are compared from the same normals: the port's FPFH of the JAX file's
    normals matches the JAX file's descriptors to 1e-3 on 95% of the points,
    and the port's file holds the FPFH of its own normals."""
    from pcl_tpu_torch.features import estimate_fpfh

    files = scans[0]
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_fpfh.main([files[0], out_t, "-k", "16", "-nk", "12", *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_fpfh.main([files[0], out_j, "-k", "16", "-nk", "12"]) == 0
    assert line_t == capsys.readouterr().out == "[fpfh_estimation] 1500 descriptors (33 bins)\n"
    (xt, at), (xj, aj) = _xyz(out_t), _xyz(out_j)
    np.testing.assert_array_equal(xt, xj)
    assert at["fpfh"].shape == (1500, 33)
    assert ((at["normal"] * aj["normal"]).sum(1) >= 1 - 1e-5).all()
    own = estimate_fpfh(make_cloud(xt, device="cpu").with_attrs(
        normal=torch.from_numpy(at["normal"])), k=16).numpy()
    np.testing.assert_array_equal(own, at["fpfh"])
    from_j = estimate_fpfh(make_cloud(xj, device="cpu").with_attrs(
        normal=torch.from_numpy(aj["normal"])), k=16).numpy()
    assert (np.abs(from_j - aj["fpfh"]).max(1) <= 1e-3).mean() > 0.95


def _outputs(files, suffix):
    return [_xyz(f.replace(".pcd", suffix + ".pcd"))[0] for f in files]


def test_lum_tool(scans, capsys):
    """Both tools find the same edges and correspondence counts (exact 1-NN
    either way; the scans hold no ties), and write clouds within 1e-4 m."""
    files = scans[0]
    args = [*files, "-corr_dist", "0.5", "-max_corr", "256", "-iter", "6"]
    assert t_lum.main([*args, "-suffix", "_t", *CPU]) == 0
    out_t = capsys.readouterr().out.splitlines()
    assert j_lum.main([*args, "-suffix", "_j"]) == 0
    out_j = capsys.readouterr().out.splitlines()
    assert out_t[:-1] == out_j[:-1] and len(out_t) == 4        # three edges, then the solve
    head_t, res_t = out_t[-1].split(" residual ")
    head_j, res_j = out_j[-1].split(" residual ")
    assert head_t == head_j == "[lum] 3 edges, 3 vertices,"
    assert res_t.split(" after ")[1] == res_j.split(" after ")[1]
    np.testing.assert_allclose(float(res_t.split()[0]), float(res_j.split()[0]), rtol=1e-4)
    for a, b in zip(_outputs(files, "_t"), _outputs(files, "_j")):
        np.testing.assert_allclose(a, b, atol=1e-4)               # metres


def test_lum_tool_without_edges(tmp_path, capsys):
    """Scans too far apart for any correspondence: both tools give up."""
    rng = np.random.default_rng(3)
    files = []
    for i in range(2):
        files.append(str(tmp_path / f"far{i}.pcd"))
        tio.save(files[-1], make_cloud(rng.uniform(-1, 1, (50, 3)) + 30 * i, device="cpu"))
    assert t_lum.main([*files, *CPU]) == 1
    assert j_lum.main(files) == 1
    assert capsys.readouterr().err.count("[lum] no edges found") == 2


def test_elch_tool(tmp_path, capsys):
    """The JAX tool's chain (a loop end 2 cm off the start): the same printed
    lines but for the fitness, which is float32 rounding here (both below
    1e-8 m^2), and corrected clouds within 1e-4 m."""
    rng = np.random.default_rng(5)
    base = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    files = []
    for i, off in enumerate([(0, 0, 0), (0.2, 0, 0), (0.02, 0, 0)]):
        files.append(str(tmp_path / f"s{i}.pcd"))
        tio.save(files[-1], make_cloud(base + np.float32(off), device="cpu"))
    args = [*files, "-dist", "0.3", "-iter", "20"]
    assert t_elch.main([*args, "-suffix", "_t", *CPU]) == 0
    out_t = capsys.readouterr().out
    assert j_elch.main([*args, "-suffix", "_j"]) == 0
    out_j = capsys.readouterr().out
    fit = [float(o.split("fitness=")[1].split()[0]) for o in (out_t, out_j)]
    assert max(fit) < 1e-8
    assert [o.split("fitness=")[0] for o in (out_t, out_j)] == ["[elch] loop ICP converged=True "] * 2
    assert out_t.splitlines()[1:] == out_j.splitlines()[1:] == ["[elch] wrote 3 corrected scans"]
    for a, b in zip(_outputs(files, "_t"), _outputs(files, "_j")):
        np.testing.assert_allclose(a, b, atol=1e-4)               # metres
    np.testing.assert_allclose(_outputs(files, "_t")[2], base, atol=1e-4)
    assert t_elch.main([*files[:2], *CPU]) == 1


def _plane_coeffs(text, head):
    line = [ln for ln in text.splitlines() if ln.startswith(head)][0]
    c = np.array([float(v) for v in line.split("coefficients=[")[1].rstrip("]").split()])
    return line, c * np.sign(c[1])


@pytest.mark.parametrize("method", ["ransac", "msac"])
def test_sac_segmentation_tool(scans, capsys, tmp_path, method):
    """The floor of the first scan (y = 0 in the room, seen from the
    scanner's pose): other samples than the JAX package's (a seeded
    generator), the same refined plane to 1e-3 and inlier counts within 1%."""
    files = scans[0]
    args = [files[0], "-model", "plane", "-thresh", "0.02", "-method", method]
    assert t_sacseg.main([*args, "-inliers", str(tmp_path / "in.pcd"),
                          "-outliers", str(tmp_path / "out.pcd"), *CPU]) == 0
    line_t, ct = _plane_coeffs(capsys.readouterr().out, "[sac_segmentation]")
    assert j_sacseg.main(args) == 0
    line_j, cj = _plane_coeffs(capsys.readouterr().out, "[sac_segmentation]")
    assert line_t.split(" inliers=")[0] == line_j.split(" inliers=")[0]
    n_t, n_j = (int(ln.split("inliers=")[1].split("/")[0]) for ln in (line_t, line_j))
    assert abs(n_t - n_j) <= 0.01 * n_j
    np.testing.assert_allclose(ct, cj, atol=1e-3)
    (xi, _), (xo, _) = _xyz(str(tmp_path / "in.pcd")), _xyz(str(tmp_path / "out.pcd"))
    assert len(xi) == n_t and len(xi) + len(xo) == 1500


def test_sac_segmentation_plane_tool(scans, capsys, tmp_path):
    files = scans[0]
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    args = ["-thresh", "0.02", "-refine", "-neg"]
    assert t_sacplane.main([files[0], out_t, *args, *CPU]) == 0
    line_t, ct = _plane_coeffs(capsys.readouterr().out, "[sac_segmentation_plane]")
    assert j_sacplane.main([files[0], out_j, *args]) == 0
    line_j, cj = _plane_coeffs(capsys.readouterr().out, "[sac_segmentation_plane]")
    np.testing.assert_allclose(ct, cj, atol=1e-3)
    n_t, n_j = (len(_xyz(o)[0]) for o in (out_t, out_j))
    assert abs(n_t - n_j) <= 0.01 * n_j and 0 < n_t < 1500


@pytest.mark.parametrize("tool", [t_voxel_grid, t_normals, t_icp, t_ndt3d, t_odometry, t_fpfh,
                                  t_sacseg, t_sacplane, t_lum, t_elch, t_hausdorff, t_ndt2d,
                                  t_icp2d, t_iter_icp, t_cloud_error, t_mls, t_gp3, t_mc,
                                  t_poisson, t_hull, t_crop],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_tools_ask_for_the_card_by_default(scans, monkeypatch, tmp_path, tool):
    """No silent move to the CPU: without a card and without --device cpu the
    tool fails with the error the constructor raises."""
    files = scans[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {t_odometry: files[:2]}.get(tool, [files[0], str(tmp_path / "o.pcd")])
    if tool in (t_icp, t_ndt3d, t_hausdorff, t_ndt2d, t_iter_icp, t_cloud_error):
        argv = files[:2]
    if tool is t_crop:
        argv = [*files[:2], str(tmp_path / "o.pcd")]
    if tool is t_icp2d:
        argv = [*files[:2], str(tmp_path / "o.pcd")]
    if tool in (t_lum, t_elch):
        argv = files
    if tool is t_sacseg:
        argv = files[:1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def _numbers(text):
    import re
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)]


def test_compute_hausdorff_tool(scans, capsys):
    """B1's exact distances against the matmul identity's (ROADMAP C1): the
    printed value to 1e-5 m."""
    files = scans[0]
    assert t_hausdorff.main([*files[:2], *CPU]) == 0
    out_t = capsys.readouterr().out
    assert j_hausdorff.main(files[:2]) == 0
    out_j = capsys.readouterr().out
    assert out_t.startswith("[compute_hausdorff] ")
    assert _numbers(out_t)[0] == pytest.approx(_numbers(out_j)[0], abs=1e-5)


def test_compute_cloud_error_tool(scans, capsys):
    files = scans[0]
    args = [*files[:2], "-correspondence", "nn"]
    assert t_cloud_error.main([*args, *CPU]) == 0
    out_t = capsys.readouterr().out
    assert j_cloud_error.main(args) == 0
    out_j = capsys.readouterr().out
    assert out_t.split()[:2] == out_j.split()[:2]            # the tag and n=
    np.testing.assert_allclose(_numbers(out_t), _numbers(out_j), atol=2e-6)


def test_compute_cloud_error_tool_by_index(scans, capsys):
    """The JAX tool's index mode writes into a read-only view of a JAX array
    and raises (ROADMAP C34); the port's is held to numpy."""
    files = scans[0]
    assert t_cloud_error.main([*files[:2], "-correspondence", "index", *CPU]) == 0
    got = _numbers(capsys.readouterr().out)
    a, b = (_xyz(f)[0].astype(np.float64) for f in files[:2])
    d = np.linalg.norm(a - b, axis=1)
    want = [np.sqrt((d ** 2).mean()), d.mean(), np.median(d), d.max()]
    np.testing.assert_allclose(got, want, atol=2e-6)
    with pytest.raises(ValueError, match="read-only"):
        j_cloud_error.main([*files[:2], "-correspondence", "index"])


def test_iterative_closest_point_tool(scans, capsys, tmp_path):
    files = scans[0]
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    args = [*files[1::-1], "-iters", "30", "-dist", "0.5"]
    assert t_iter_icp.main([args[0], args[1], out_t, *args[2:], *CPU]) == 0
    text_t = capsys.readouterr().out
    assert j_iter_icp.main([args[0], args[1], out_j, *args[2:]]) == 0
    text_j = capsys.readouterr().out
    assert text_t.splitlines()[0].startswith("[iterative_closest_point] converged=True")
    np.testing.assert_allclose(_numbers("\n".join(text_t.splitlines()[1:])),
                               _numbers("\n".join(text_j.splitlines()[1:])), atol=1e-3)
    np.testing.assert_allclose(_xyz(out_t)[0], _xyz(out_j)[0], atol=2e-3)


@pytest.fixture(scope="module")
def planar(tmp_path_factory):
    """Two laser scans of a room's walls in the xy plane (z = 0), the second
    moved by (0.15, -0.1) m and 0.08 rad, as PCD files."""
    root = tmp_path_factory.mktemp("planar")
    rng = np.random.default_rng(42)
    t = rng.uniform(0, 4, 400).astype(np.float32)
    pts = np.concatenate([np.stack([t, np.zeros_like(t)], 1), np.stack([np.zeros_like(t), t], 1),
                          np.stack([t, np.full_like(t, 4.0)], 1)])
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    c, s = np.cos(0.08), np.sin(0.08)
    src = (pts - np.float32([0.15, -0.1])) @ np.array([[c, -s], [s, c]], np.float32)
    files = []
    for name, xy in (("src", src), ("tgt", pts)):
        xyz = np.concatenate([xy, np.zeros((len(xy), 1), np.float32)], 1).astype(np.float32)
        files.append(str(root / f"{name}.pcd"))
        tio.save(files[-1], make_cloud(xyz, device="cpu"))
    return files


def test_ndt2d_tool(planar, capsys, tmp_path):
    """The same parameters to 5e-3 (ROADMAP C33: Newton zigzags at the
    coarsest level) and converged alike; the moved source is written."""
    out = str(tmp_path / "aligned.pcd")
    assert t_ndt2d.main([*planar, out, "-grid", "0.8", "-iters", "30", *CPU]) == 0
    text_t = capsys.readouterr().out.splitlines()
    assert j_ndt2d.main([*planar, "-grid", "0.8", "-iters", "30"]) == 0
    text_j = capsys.readouterr().out.splitlines()
    assert text_t[0].split()[:2] == text_j[0].split()[:2] == ["[ndt2d]", "converged=True"]
    np.testing.assert_allclose(_numbers(text_t[1]), _numbers(text_j[1]), atol=5e-3)
    np.testing.assert_allclose(_numbers(text_t[1]), [0.15, -0.1, 0.08], atol=0.02)
    assert _xyz(out)[0].shape == (1200, 3)


def test_icp2d_tool(planar, capsys, tmp_path):
    """B1 in place of the kd-tree: the printed pose to 1e-3 (the last digit
    printed) and the written clouds to 1e-3 m."""
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_icp2d.main([*planar, out_t, *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_icp2d.main([*planar, out_j]) == 0
    line_j = capsys.readouterr().out
    assert line_t.startswith("[icp2d] t=(")
    np.testing.assert_allclose(_numbers(line_t), _numbers(line_j), atol=1e-3)
    np.testing.assert_allclose(_xyz(out_t)[0], _xyz(out_j)[0], atol=1e-3)


def test_vfh_estimation_tool(scans, capsys, tmp_path):
    """VFH of a scan: both tools estimate their own normals (1e-5 apart,
    ROADMAP C9), so a point whose pair feature lies on a bin edge may vote
    in the next bin: the descriptors agree to two votes (2 x 100 / 1500) a
    bin, and each block sums to 100 on both."""
    f = scans[0][0]
    out_t, out_j = str(tmp_path / "t.npy"), str(tmp_path / "j.npy")
    assert t_vfh.main([f, out_t, "-k", "12", *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_vfh.main([f, out_j, "-k", "12"]) == 0
    line_j = capsys.readouterr().out
    assert line_t.startswith("[vfh_estimation] 1500 pts -> VFH[308]")
    assert line_t.split("(")[0] == line_j.split("(")[0]
    vt, vj = np.load(out_t), np.load(out_j)
    assert vt.shape == vj.shape == (308,)
    assert np.abs(vt - vj).max() <= 2 * 100.0 / 1500 + 1e-4
    for blk in (slice(0, 45), slice(45, 90), slice(90, 135), slice(135, 180), slice(180, 308)):
        assert abs(vt[blk].sum() - 100.0) < 1e-3


def test_spin_estimation_tool(scans, capsys, tmp_path):
    """Spin images of a scan from each tool's own normals: rows agree to
    1e-5 wherever no neighbour lies on a bin edge; 99% of the rows here."""
    f = scans[0][0]
    out_t, out_j = str(tmp_path / "t.npy"), str(tmp_path / "j.npy")
    assert t_spin.main([f, out_t, "-radius", "0.3", "-k", "12", *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_spin.main([f, out_j, "-radius", "0.3", "-k", "12"]) == 0
    assert line_t == capsys.readouterr().out == \
        "[spin_estimation] 1500 pts -> spin images (1500, 153)\n"
    st, sj = np.load(out_t), np.load(out_j)
    assert (np.abs(st - sj).max(1) <= 1e-5).mean() >= 0.99


def test_boundary_estimation_tool(scans, capsys, tmp_path):
    """Boundary points of a scan: the same points on both, but for a point
    whose largest angular gap lies within the normals' 1e-5 of the angle."""
    f = scans[0][0]
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_boundary.main([f, out_t, "-radius", "0.3", *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_boundary.main([f, out_j, "-radius", "0.3"]) == 0
    line_j = capsys.readouterr().out
    bt, bj = _xyz(out_t)[0], _xyz(out_j)[0]
    assert 20 <= len(bj) < 1500
    common = len({tuple(p) for p in bt} & {tuple(p) for p in bj})
    assert common >= len(bj) - 2 and len(bt) <= len(bj) + 2
    if len(bt) == len(bj):
        assert line_t == line_j


def _mesh(path):
    from pcl_tpu_torch.io import ply

    c, faces = ply.load_mesh(path, device="cpu")
    return to_numpy(c)[0], faces


def _hausdorff(a, b):
    from scipy.spatial import cKDTree

    return max(cKDTree(a).query(b)[0].max(), cKDTree(b).query(a)[0].max())


def test_mls_smoothing_tool(scans, capsys, tmp_path):
    """The same line and the smoothed points to 1e-5 m; the normals to 1e-4
    up to their sign, which on a plane the sign of a rounding-sized height
    decides (ROADMAP C64), on every point with a curvature and on 99% of all
    (a point with fewer than six neighbours keeps the plane normal of a
    degenerate covariance)."""
    f = scans[0][0]
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    assert t_mls.main([f, out_t, "-radius", "0.3", *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_mls.main([f, out_j, "-radius", "0.3"]) == 0
    assert line_t == capsys.readouterr().out == \
        "[mls_smoothing] smoothed 1500 points (radius 0.3, order 2)\n"
    (xt, at), (xj, aj) = _xyz(out_t), _xyz(out_j)
    np.testing.assert_allclose(xt, xj, atol=1e-5)
    agree = np.abs((at["normal"] * aj["normal"]).sum(1)) >= 1 - 1e-4
    fitted = (at["curvature"] > 0) & (aj["curvature"] > 0)
    assert agree[fitted].all() and agree.mean() >= 0.99


@pytest.fixture(scope="module")
def ball_file(tmp_path_factory):
    """A noisy sphere as a PCD file: the RBF tool's input (on the room scans
    its r^3 system is too ill-conditioned for float32, ROADMAP C66)."""
    import torch_surface_scenes as S

    path = str(tmp_path_factory.mktemp("ball") / "ball.pcd")
    tio.save(path, make_cloud(S.sphere(0, 800)[0], device="cpu"))
    return path


@pytest.mark.parametrize("tool,args", [
    ("gp3", ["-radius", "0.5", "-k", "12"]), ("hoppe", ["-grid_res", "24"]),
    ("rbf", ["-method", "rbf", "-grid_res", "20"]), ("poisson", ["-depth", "5"])])
def test_mesh_tools(scans, ball_file, capsys, tmp_path, tool, args):
    """Each tool estimates its own normals (1e-5 apart, ROADMAP C9) and the
    JAX 1-NN rounds another way (C55): the meshes lie within 2 cm, a tenth
    of their grid cell (GP3: the same vertices, triangle counts within 2%;
    RBF within one cell: its ill-conditioned solve amplifies the normals'
    difference, C66)."""
    f = ball_file if tool == "rbf" else scans[0][0]
    t_mod, j_mod = {"gp3": (t_gp3, j_gp3), "poisson": (t_poisson, j_poisson)}.get(
        tool, (t_mc, j_mc))
    out_t, out_j = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    assert t_mod.main([f, out_t, *args, *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_mod.main([f, out_j, *args]) == 0
    line_j = capsys.readouterr().out
    assert line_t.split()[0] == line_j.split()[0]
    (vt, ft), (vj, fj) = _mesh(out_t), _mesh(out_j)
    assert len(ft) > 100 and abs(len(ft) - len(fj)) <= 0.02 * len(fj)
    if tool == "gp3":
        np.testing.assert_array_equal(vt, vj)
    else:
        assert _hausdorff(vt, vj) <= (0.06 if tool == "rbf" else 0.02)


def test_mesh_tools_write_pcd_vertices_and_refuse_vtk(scans, capsys, tmp_path):
    f = scans[0][0]
    out = str(tmp_path / "v.pcd")
    assert t_hull.main([f, out, *CPU]) == 0
    verts, faces = _mesh_of_hull(tmp_path, f, capsys)
    np.testing.assert_array_equal(_xyz(out)[0], verts)
    # .vtk and .ifs meshes (slice 14): the files the JAX tool writes, byte
    # for byte
    capsys.readouterr()
    for ext in (".vtk", ".ifs"):
        a, b = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
        assert t_gp3.main([f, a, *CPU]) == 0
        assert j_gp3.main([f, b]) == 0
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def _mesh_of_hull(tmp_path, f, capsys):
    out = str(tmp_path / "h.ply")
    assert t_hull.main([f, out, *CPU]) == 0
    capsys.readouterr()
    return _mesh(out)


def test_compute_hull_tool(scans, capsys, tmp_path):
    """Qhull on the host in both: the same mesh, bit for bit."""
    f = scans[0][0]
    out_t, out_j = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    assert t_hull.main([f, out_t, *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_hull.main([f, out_j]) == 0
    assert line_t == capsys.readouterr().out
    (vt, ft), (vj, fj) = _mesh(out_t), _mesh(out_j)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(ft) > 10


def test_compute_hull_tool_concave(scans, capsys, tmp_path):
    """With -alpha the JAX tool fails writing its 2-D hull's edges as
    triangles (ROADMAP C65); the port's writes the 3-D alpha shape, equal to
    the JAX package's ``concave_hull(dim=3)``."""
    from pcl_tpu import io as jio
    from pcl_tpu.surface.hulls import concave_hull as j_concave

    f = scans[0][0]
    with pytest.raises(ValueError, match="broadcast"):
        j_hull.main([f, str(tmp_path / "j.ply"), "-alpha", "0.4"])
    capsys.readouterr()
    out_t = str(tmp_path / "t.ply")
    assert t_hull.main([f, out_t, "-alpha", "0.4", *CPU]) == 0
    vj, fj = j_concave(jio.load(f), 0.4, dim=3)
    vt, ft = _mesh(out_t)
    assert capsys.readouterr().out == \
        f"[compute_hull] 1500 pts -> {len(vj)} verts, {len(fj)} facets\n"
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("outside", [False, True])
def test_crop_to_hull_tool(scans, capsys, tmp_path, outside):
    files = scans[0]
    out_t, out_j = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    flag = ["--outside"] if outside else []
    assert t_crop.main([files[1], files[0], out_t, *flag, *CPU]) == 0
    line_t = capsys.readouterr().out
    assert j_crop.main([files[1], files[0], out_j, *flag]) == 0
    assert line_t == capsys.readouterr().out
    np.testing.assert_array_equal(_xyz(out_t)[0], _xyz(out_j)[0])
    assert 0 < len(_xyz(out_t)[0]) < 1500
