"""Path Q's chain at 3 VLP-16 sweeps of a street cut to 10 m of range
(``chip_smoke.Q_SMALL``) on the port beside the JAX package's calls
(``tests/rehearse_path_q.jax_chain``: the same chain on ``JaxQ``, one shape
per JAX function in the front end), the JAX side's map built from the port's
poses; then ``path_q_metrics`` and ``q_checks``' exact checks on the port's
run.

Tolerances:
- (b), (e) and the views' files: equal bit for bit (both packages run the
  same numpy code on the same rows): the sweeps and their intensities, the
  CLIs' PCD files, the compressed streams, the range coder's stream, the
  organized blob, the depth buffers, the image and TiM grabbers' points, the
  HTML, SVG and PNG files and the CLIs' printed lines.
- (c) The front end's voxels to 1e-5 m (each package's segment sums), the
  poses to 1e-4 (as ``test_torch_trajectory``'s odometry: the two 1-NN and
  normals round apart, C1).
- (d) Given the same poses, the flat store's and the tree's files equal bit
  for bit, and so the queries; the map's voxels to 1e-5 m and their squared
  distances to the street to 4 x 2^-22 (q^2 + t^2) (the JAX package's CPU
  1-NN expands the square, ROADMAP C1).
- (f) What rounds apart: the range image's pixels equal (to 1e-6, the
  norm's rounding) but where a return lies within 1e-4 pixel of a pixel's
  edge (C27; the counts of filled pixels within 0.5%); registration_visualizer's MSE within 1e-4 relative or 1e-7 m^2 (as
  in ``test_torch_tools_stream``); the octree viewers' printed lines equal.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import re

import numpy as np
import pytest

import chip_smoke as cs
import rehearse_path_q as rq


def _edge_pixels(xyz, shape, res=np.radians(0.5), eps=1e-4):
    """The pixels of the range image (``PortQ.range_image``: z ahead = the
    sweep's y, y up = its z, 0.5 deg) that a return within ``eps`` pixel of a
    pixel's edge may reach: its pixel and the eight about it, where the two
    packages' float32 angles may put it (ROADMAP C27)."""
    H, W = shape
    p = np.stack([-xyz[:, 0], xyz[:, 2], xyz[:, 1]], 1).astype(np.float64)
    u = np.arctan2(p[:, 0], p[:, 2]) / res + W / 2.0
    v = np.arcsin(p[:, 1] / np.linalg.norm(p, axis=1)) / res + H / 2.0
    near = (np.abs(u - np.round(u)) < eps) | (np.abs(v - np.round(v)) < eps)
    uu, vv = np.floor(u[near]).astype(int), np.floor(v[near]).astype(int)
    out = np.zeros(shape, bool)
    for du in (-1, 0, 1):
        for dv in (-1, 0, 1):
            a, b = uu + du, vv + dv
            ok = (a >= 0) & (a < W) & (b >= 0) & (b < H)
            out[b[ok], a[ok]] = True
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    Q = cs.Q_SMALL
    inp = cs.path_q_inputs(Q, str(tmp_path_factory.mktemp("path_q")))
    p, _ = cs.path_q_chain(inp, Q, "cpu")
    j, _ = rq.jax_chain(inp, Q, poses=p["poses"])
    return inp, Q, j, p


def test_path_q_replay_matches_jax(runs):
    inp, Q, j, p = runs
    for key in ("sweeps VLP16", "intensity VLP16", "cli sweeps"):
        assert len(p[key]) == len(j[key]) == 3
        for a, b in zip(p[key], j[key]):
            np.testing.assert_array_equal(a, b)
    assert p["both ways VLP16"] == j["both ways VLP16"] == (3, 3, True)
    assert p["cli same"] and j["cli same"]
    assert all(p["files"][f"sweep {k}"] == j["files"][f"sweep {k}"] for k in range(3))


def test_path_q_front_end_matches_jax(runs):
    inp, Q, j, p = runs
    for a, b in zip(p["front voxels"], j["front voxels"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    np.testing.assert_allclose(p["poses"], j["poses"], atol=1e-4)
    assert all(p["icp"]["converged"]) and all(j["icp"]["converged"])


def test_path_q_map_matches_jax(runs):
    inp, Q, j, p = runs
    for key in ("map points", "store", "tree", "query box", "query frustum", "query bb",
                "html rows"):
        assert p[key] == j[key], key
    for name in p["files"]:
        if name.startswith(("ooc/", "hier/")):
            assert p["files"][name] == j["files"].get(name), name
    assert {k for k in p["files"] if k.startswith(("ooc/", "hier/"))} == \
        {k for k in j["files"] if k.startswith(("ooc/", "hier/"))}
    np.testing.assert_allclose(p["map voxels"], j["map voxels"], atol=1e-5, rtol=0)
    # C1: the JAX package's CPU 1-NN expands |q - t|^2 as |q|^2 - 2 q.t + |t|^2,
    # ~2^-22 (q^2 + t^2) of rounding, |t| at most |q| + |q - t|
    q = np.linalg.norm(p["map voxels"].astype(np.float64), axis=1)
    d2 = p["surface nn"][1].astype(np.float64)
    tol = 4 * 2.0 ** -22 * (q ** 2 + (q + np.sqrt(d2)) ** 2)
    assert (np.abs(d2 - j["surface nn"][1]) <= tol).all()


def test_path_q_streams_match_jax(runs):
    inp, Q, j, p = runs
    for key in ("compression", "range coder", "organized", "blob 0", "cli image"):
        assert p[key] == j[key], key
    for (pm, pa), (jm, ja) in zip(p["buffers"], j["buffers"]):
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pa, ja)
    assert len(p["image grabber"]) == len(j["image grabber"]) == Q["frames"]
    for a, b in zip(p["image grabber"], j["image grabber"]):
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)
    assert p["tim"][2] and j["tim"][2]
    for a, b in zip(p["tim"][0], j["tim"][0]):
        np.testing.assert_array_equal(a, b)
    for name in p["files"]:
        if name.startswith("frames/"):
            assert p["files"][name] == j["files"][name], name


def test_path_q_views_match_jax(runs):
    inp, Q, j, p = runs
    html = sorted(k for k in p["files"] if k.startswith("html/"))
    assert html == sorted(k for k in j["files"] if k.startswith("html/")) and len(html) == 10
    for name in html:
        assert p["files"][name] == j["files"][name], name
    assert p["rounded files"] == j["rounded files"]
    for key in ("ascii", "mesh", "pick"):
        assert p[key] == j[key], key
    assert p["live"] == j["live"]
    filled = [int(np.isfinite(x).sum()) for x in (p["ranges"], j["ranges"])]
    assert abs(filled[0] - filled[1]) <= 0.005 * filled[1]
    firm = ~_edge_pixels(p["sweeps VLP16"][0], p["ranges"].shape)
    assert firm.mean() >= 0.9
    a, b = p["ranges"][firm], j["ranges"][firm]
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=1e-6)
    for name, (rc, text) in p["cli views"].items():
        jrc, jtext = j["cli views"][name]
        assert rc == jrc == 0, name
        if name == "registration_visualizer":
            mt = [float(m) for m in re.findall(r"mse=([0-9.e+-]+)", text)]
            mj = [float(m) for m in re.findall(r"mse=([0-9.e+-]+)", jtext)]
            assert len(mt) == len(mj) == 3
            np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-7)
        else:
            assert text == jtext, name


def test_path_q_checks_on_the_port(runs):
    inp, Q, j, p = runs
    m = cs.path_q_metrics(inp, p, Q)
    failed = []
    printed = cs.q_checks(m, cs.Q_LIMITS, Q, lambda ok, what: ok or failed.append(what), "cpu")
    assert failed == []
    assert all(("ATE" in w or "surface" in w) for w in printed)
    assert m["decode err VLP16"] <= cs.Q_DECODE_TOL and m["tim"]["err"] <= cs.Q_TIM_TOL
    assert m["compression"]["exact"] and m["range coder"]["round_trip"]
    jm = cs.path_q_metrics(inp, j, Q)
    assert abs(m["ate"] - jm["ate"]) <= 1e-4
