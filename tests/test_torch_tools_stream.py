"""The port's stream, storage and viewer CLIs on the CPU (``--device cpu``)
beside the JAX package's CLIs, on files the test writes: the Velodyne pcap
tools, the image and PCD grabber tools, the viewers, the octree viewers, the
registration visualizer, and concatenate_points_pcd, transform_point_cloud
and pclzf2pcd.

Tolerances: files that both packages write from the same rows (PCD, HTML,
PNG) are equal byte for byte, and so are the printed lines (less the
paths). ``registration_visualizer`` runs ICP on each package's 1-NN: its
MSE agrees to 1e-4 relative, or to 1e-7 m^2
once both have converged to their float32 rounding (the JAX run stops near
5e-8 m^2 on this 4 m patch, the port near 2e-14), so its SVGs are
compared as the numbers they hold (polyline vertices to 0.15 px, the
printed pixel step of 0.1 px plus a rounding either side). The grabber
viewers print a measured frame rate, which is left out.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib
import os
import re

import numpy as np
import pytest

from pcl_tpu.core.cloud import from_numpy as jfrom
from pcl_tpu.io import pcd as jpcd

from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core.cloud import to_numpy
from pcl_tpu_torch.io import velodyne as tvel

CPU = ["--device", "cpu"]


def _tools(name):
    return (importlib.import_module(f"pcl_tpu_torch.tools.{name}"),
            importlib.import_module(f"pcl_tpu.tools.{name}"))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _capture(rng, n_rev, blocks, step):
    """A capture of ``n_rev`` revolutions: each starts a new packet (the last
    packet padded with empty blocks), ranges on a ring of walls 5-30 m out."""
    pkts = []
    for _ in range(n_rev):
        n_pk = -(-blocks // 12)
        for p in range(n_pk):
            b = 12 * p + np.arange(12)
            az = (b * step) % 360.0
            dist = np.where(b[:, None] < blocks, rng.uniform(5.0, 30.0, (12, 32)), 0.0)
            dist[rng.random((12, 32)) < 0.1] = 0.0
            pkts.append(tvel.encode_packet(az, dist, rng.integers(0, 256, (12, 32))))
    return pkts


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_tools")
    rng = np.random.default_rng(50)
    out = {"vlp": str(d / "vlp.pcap"), "hdl": str(d / "hdl.pcap"), "npy": str(d / "npy"),
           "seq": str(d / "seq"), "org": str(d / "org.pcd"), "src": str(d / "src.pcd"),
           "tgt": str(d / "tgt.pcd"), "zf": str(d / "zf.pcd")}
    tvel.write_pcap(out["vlp"], _capture(rng, 3, 300, 1.2))
    tvel.write_pcap(out["hdl"], _capture(rng, 2, 450, 0.8))
    os.makedirs(out["npy"])
    os.makedirs(out["seq"])
    H, W = 24, 32
    for k in range(3):
        z = rng.uniform(0.5, 4.0, size=(H, W)).astype(np.float32)
        z[rng.random(z.shape) < 0.1] = 0.0
        np.save(os.path.join(out["npy"], f"f{k:02d}.npy"), z)
        jpcd.save(os.path.join(out["seq"], f"s{k}.pcd"),
                  jfrom(rng.normal(size=(100 + k, 3)).astype(np.float32)))
    v, u = np.mgrid[0:H, 0:W]
    depth = (2.0 + 0.3 * np.sin(u / 4.0)).astype(np.float32)
    depth[rng.random((H, W)) < 0.05] = 0.0
    org = np.stack([(u - 16) / 40 * depth, (v - 12) / 40 * depth, depth], -1)
    org = np.where(depth[..., None] > 0, org, np.nan).reshape(-1, 3).astype(np.float32)
    jpcd.save(out["org"], jfrom(org, {"rgb": rng.uniform(size=(H * W, 3)).astype(np.float32)},
                                width=W, height=H))
    # a registration pair: a bumpy patch and a copy moved by a small motion
    g = rng.uniform(-2, 2, size=(400, 2))
    tgt = np.c_[g, 0.3 * np.sin(2 * g[:, 0]) * np.cos(g[:, 1])].astype(np.float32)
    a = np.radians(4.0)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    src = (tgt @ R.T + [0.08, -0.05, 0.02]).astype(np.float32)
    jpcd.save(out["src"], jfrom(src))
    jpcd.save(out["tgt"], jfrom(tgt))
    jpcd.save(out["zf"], jfrom(src, {"intensity": rng.random(400).astype(np.float32)}))
    return out


def _run(name, t_args, j_args, capsys):
    t_mod, j_mod = _tools(name)
    rt = t_mod.main([*t_args, *CPU])
    out_t = capsys.readouterr().out
    rj = j_mod.main(j_args)
    out_j = capsys.readouterr().out
    assert rt == rj
    return out_t, out_j


def _same_pcd(a, b):
    ca, cb = tio.load(a, device="cpu"), tio.load(b, device="cpu")
    assert (ca.width, ca.height) == (cb.width, cb.height)
    np.testing.assert_array_equal(ca.mask.numpy(), cb.mask.numpy())
    np.testing.assert_array_equal(ca.xyz.numpy(), cb.xyz.numpy())
    assert sorted(ca.attrs) == sorted(cb.attrs)
    for k in ca.attrs:
        np.testing.assert_array_equal(ca.attrs[k].numpy(), cb.attrs[k].numpy())


@pytest.mark.parametrize("model,cap", [("VLP16", "vlp"), ("HDL32E", "hdl")])
def test_pcap_to_pcd_matches_jax(files, tmp_path, capsys, model, cap):
    pt, pj = str(tmp_path / "t"), str(tmp_path / "j")
    out_t, out_j = _run("pcap_to_pcd", [files[cap], pt, "-model", model],
                        [files[cap], pj, "-model", model], capsys)
    assert out_t == out_j
    n = int(out_t.split()[1])
    assert n == (3 if cap == "vlp" else 2)
    for k in range(n):
        assert _bytes(f"{pt}_{k:03d}.pcd") == _bytes(f"{pj}_{k:03d}.pcd")
    # -max_sweeps stops early
    _run("pcap_to_pcd", [files[cap], pt + "m", "-model", model, "-max_sweeps", "1"],
         [files[cap], pj + "m", "-model", model, "-max_sweeps", "1"], capsys)
    assert not os.path.exists(f"{pt}m_001.pcd")


def test_hdl_grabber_example_matches_jax(files, tmp_path, capsys):
    out_t, out_j = _run("hdl_grabber_example", [files["hdl"]], [files["hdl"]], capsys)
    assert out_t == out_j and "2 sweeps total" in out_t
    # -save writes the sweeps pcap_to_pcd writes
    save = str(tmp_path / "g")
    t_mod, _ = _tools("hdl_grabber_example")
    assert t_mod.main([files["hdl"], "-save", save, *CPU]) == 0
    ref = str(tmp_path / "p")
    _tools("pcap_to_pcd")[0].main([files["hdl"], ref, "-model", "HDL32E", *CPU])
    for k in range(2):
        assert _bytes(f"{save}_{k:03d}.pcd") == _bytes(f"{ref}_{k:03d}.pcd")


@pytest.mark.parametrize("name,cap", [("hdl_viewer_simple", "hdl"), ("vlp_viewer", "vlp")])
def test_velodyne_viewers_match_jax(files, tmp_path, capsys, name, cap):
    ht, hj = str(tmp_path / "t.html"), str(tmp_path / "j.html")
    out_t, out_j = _run(name, [files[cap], "-html", ht], [files[cap], "-html", hj], capsys)
    assert out_t.replace(ht, "") == out_j.replace(hj, "")
    assert _bytes(ht) == _bytes(hj)
    out_t, out_j = _run(name, [files[cap], "-max_sweeps", "1"], [files[cap], "-max_sweeps", "1"],
                        capsys)
    assert out_t == out_j and "1 sweeps replayed" in out_t


def test_image_grabber_saver_matches_jax(files, tmp_path, capsys):
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    out_t, out_j = _run("image_grabber_saver", [files["npy"], dt, "-focal", "40"],
                        [files["npy"], dj, "-focal", "40"], capsys)
    assert out_t.replace(dt, "") == out_j.replace(dj, "")
    names = sorted(os.listdir(dt))
    assert names == sorted(os.listdir(dj)) and len(names) == 3
    for n in names:
        assert _bytes(os.path.join(dt, n)) == _bytes(os.path.join(dj, n))


def test_image_grabber_viewer_matches_jax(files, tmp_path, capsys):
    ht, hj = str(tmp_path / "t.html"), str(tmp_path / "j.html")
    out_t, out_j = _run("image_grabber_viewer", [files["npy"], "-html", ht, "-max_frames", "2"],
                        [files["npy"], "-html", hj, "-max_frames", "2"], capsys)
    assert out_t.replace(ht, "") == out_j.replace(hj, "") and "2 frames" in out_t
    assert _bytes(ht) == _bytes(hj)


def test_image_viewer_matches_jax(files, tmp_path, capsys):
    rt, rj = str(tmp_path / "t_rgb.png"), str(tmp_path / "j_rgb.png")
    dt, dj = str(tmp_path / "t_d.png"), str(tmp_path / "j_d.png")
    out_t, out_j = _run("image_viewer", [files["org"], "-rgb", rt, "-depth", dt],
                        [files["org"], "-rgb", rj, "-depth", dj], capsys)
    assert out_t.replace(rt, "").replace(dt, "") == out_j.replace(rj, "").replace(dj, "")
    assert _bytes(rt) == _bytes(rj) and _bytes(dt) == _bytes(dj)
    t_mod, _ = _tools("image_viewer")
    with pytest.raises(SystemExit):
        t_mod.main([files["src"], *CPU])


def _no_rate(text):
    return re.sub(r"[0-9.]+ fps", "fps", text)


def test_pcd_grabber_viewer_matches_jax(files, tmp_path, capsys):
    ht, hj = str(tmp_path / "t.html"), str(tmp_path / "j.html")
    out_t, out_j = _run("pcd_grabber_viewer", [files["seq"], "-html", ht],
                        [files["seq"], "-html", hj], capsys)
    assert _no_rate(out_t.replace(ht, "")) == _no_rate(out_j.replace(hj, ""))
    assert "3 frames" in out_t and _bytes(ht) == _bytes(hj)


def test_pcd_viewer_matches_jax(files, tmp_path, capsys):
    ht, hj = str(tmp_path / "t.html"), str(tmp_path / "j.html")
    ins = [os.path.join(files["seq"], f"s{k}.pcd") for k in range(3)]
    out_t, out_j = _run("pcd_viewer", [*ins, "-html", ht, "-ascii"],
                        [*ins, "-html", hj, "-ascii"], capsys)
    assert out_t.replace(ht, "") == out_j.replace(hj, "")
    assert _bytes(ht) == _bytes(hj)
    # with colour: the organized cloud's rgb rides along
    out_t, out_j = _run("pcd_viewer", [files["org"], "-html", ht, "-axis", "0", "-ascii"],
                        [files["org"], "-html", hj, "-axis", "0", "-ascii"], capsys)
    assert out_t.replace(ht, "") == out_j.replace(hj, "")
    assert _bytes(ht) == _bytes(hj) and b"const COL = null" not in _bytes(ht)


@pytest.mark.parametrize("name", ["octree_viewer", "obj_rec_ransac_orr_octree"])
def test_octree_viewers_match_jax(files, tmp_path, capsys, name):
    ht, hj = str(tmp_path / "t.html"), str(tmp_path / "j.html")
    if name == "octree_viewer":
        args_t, args_j = [files["src"], ht, "-resolution", "0.3"], [files["src"], hj,
                                                                    "-resolution", "0.3"]
    else:
        args_t, args_j = [files["src"], "-leaf", "0.3", "-html", ht], [files["src"], "-leaf",
                                                                       "0.3", "-html", hj]
    out_t, out_j = _run(name, args_t, args_j, capsys)
    assert out_t.replace(ht, "") == out_j.replace(hj, "")
    assert _bytes(ht) == _bytes(hj)


def _svg_numbers(path):
    text = open(path).read()
    polys = [np.array([[float(v) for v in p.split(",")] for p in pts.split()])
             for pts in re.findall(r'points="([^"]*)"', text)]
    return polys, re.sub(r'points="[^"]*"', "", re.sub(r"mse=[0-9.e+-]+", "", text))


def test_registration_visualizer_matches_jax(files, tmp_path, capsys):
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    out_t, out_j = _run("registration_visualizer",
                        [files["src"], files["tgt"], dt, "-iters", "12", "-stages", "3"],
                        [files["src"], files["tgt"], dj, "-iters", "12", "-stages", "3"], capsys)
    mt = [float(m) for m in re.findall(r"mse=([0-9.e+-]+)", out_t)]
    mj = [float(m) for m in re.findall(r"mse=([0-9.e+-]+)", out_j)]
    assert len(mt) == len(mj) == 3 and mt[-1] < 1e-3 * mt[0] + 1e-6
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-7)
    names = sorted(os.listdir(dt))
    assert names == sorted(os.listdir(dj)) == ["mse.svg", "stage_000.svg", "stage_001.svg",
                                              "stage_002.svg"]
    for n in names:
        (pt, rest_t), (pj, rest_j) = _svg_numbers(os.path.join(dt, n)), \
            _svg_numbers(os.path.join(dj, n))
        if n != "mse.svg":
            assert rest_t == rest_j
        assert len(pt) == len(pj)
        for a, b in zip(pt, pj):
            assert a.shape == b.shape
            if n != "mse.svg":
                assert np.abs(a - b).max() <= 0.15


def test_concatenate_points_pcd_matches_jax(files, tmp_path, capsys):
    ins = [os.path.join(files["seq"], f"s{k}.pcd") for k in range(3)]
    ot, oj = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    out_t, out_j = _run("concatenate_points_pcd", [*ins, ot], [*ins, oj], capsys)
    assert out_t.replace(ot, "") == out_j.replace(oj, "") and "303 points" in out_t
    assert _bytes(ot) == _bytes(oj)
    t_mod, _ = _tools("concatenate_points_pcd")
    assert t_mod.main([ins[0], ot, *CPU]) == 1


@pytest.mark.parametrize("flags", [["-trans", "1,2,3"], ["-axisangle", "0,0,1,0.5"],
                                   ["-quat", "0.1,0.2,0.3,0.9", "-trans", "0.5,0,0"],
                                   ["-matrix", "1,0,0,1,0,0,-1,2,0,1,0,3,0,0,0,1"],
                                   ["-axisangle", "1,1,0,-1.2", "-scale", "2"]])
def test_transform_point_cloud_matches_jax(files, tmp_path, capsys, flags):
    ot, oj = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    out_t, out_j = _run("transform_point_cloud", [files["zf"], ot, *flags],
                        [files["zf"], oj, *flags], capsys)
    assert out_t.replace(ot, "") == out_j.replace(oj, "")
    _same_pcd(ot, oj)


def test_pclzf2pcd_matches_jax(files, tmp_path, capsys):
    ot, oj = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    out_t, out_j = _run("pclzf2pcd", [files["zf"], ot], [files["zf"], oj], capsys)
    assert out_t == out_j
    assert _bytes(ot) == _bytes(oj) and b"DATA binary\n" in _bytes(ot)
    xyz, attrs = to_numpy(tio.load(ot, device="cpu"))
    xz, az = to_numpy(tio.load(files["zf"], device="cpu"))
    np.testing.assert_array_equal(xyz, xz)
    np.testing.assert_array_equal(attrs["intensity"], az["intensity"])
