"""The port's headless visualization beside the JAX package's on the same
numpy inputs, made from a seed: the HTML viewers, the ASCII render, the SVG
plots, the PGM range image, ``Visualizer``'s registries, events and
frames, and ``LiveViewer``'s GET and POST on loopback.

Tolerances: none. Both packages run the same numpy code over the same rows
(``to_numpy`` keeps the cloud's order, so ``default_rng(0)``'s subsample
picks the same points), so every file is equal byte for byte and every
frame and event equal. Every HTTP request has a 10 s timeout and every
viewer is closed, its server thread joined.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import base64
import json
import threading
import urllib.request

import numpy as np
import pytest

from pcl_tpu.core.cloud import from_numpy as jfrom
from pcl_tpu import visualization as jvis

from pcl_tpu_torch.core.cloud import from_numpy
from pcl_tpu_torch import visualization as tvis

TIMEOUT_S = 10


def _read(path, mode="rb"):
    with open(path, mode) as f:
        return f.read()


def _both(tmp_path, name, write):
    """Call ``write(module, path)`` with each package; returns both files."""
    a, b = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    write(tvis, a)
    write(jvis, b)
    return _read(a), _read(b)


def _cloud(pkg, xyz, rgb=None):
    attrs = None if rgb is None else {"rgb": rgb}
    return from_numpy(xyz, attrs, device="cpu") if pkg is tvis else jfrom(xyz, attrs)


@pytest.mark.parametrize("n,with_rgb,nan_rows", [(300, False, 0), (2500, True, 7),
                                                  (2500, False, 3)])
def test_cloud_to_html_matches_jax(tmp_path, n, with_rgb, nan_rows):
    rng = np.random.default_rng(40)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz[rng.choice(n, nan_rows, replace=False)] = np.nan        # masked rows
    rgb = rng.random((n, 3)).astype(np.float32) if with_rgb else None
    a, b = _both(tmp_path, "c.html", lambda m, p: m.cloud_to_html(
        p, _cloud(m, xyz, rgb), max_points=1000, title=None if n < 1000 else "sub"))
    assert a == b
    # the payload is the rows default_rng(0) picks from the valid rows
    html = a.decode()
    payload = json.loads(html.split("const PTS = ")[1].split(";")[0])
    pts = np.frombuffer(base64.b64decode(payload), np.float32).reshape(-1, 3)
    valid = xyz[np.isfinite(xyz).all(1)]
    if len(valid) > 1000:
        valid = valid[np.random.default_rng(0).choice(len(valid), 1000, replace=False)]
    np.testing.assert_array_equal(pts, valid)


def test_mesh_to_html_and_ascii_match_jax(tmp_path):
    rng = np.random.default_rng(41)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    f = rng.integers(0, 40, size=(60, 3)).astype(np.int32)
    a, b = _both(tmp_path, "m.html", lambda m, p: m.mesh_to_html(p, v, f))
    assert a == b
    xyz = rng.uniform(-1, 1, size=(3000, 3)).astype(np.float32)
    for axis in (0, 1, 2):
        art = tvis.render_ascii(_cloud(tvis, xyz), 50, 20, axis)
        assert art == jvis.render_ascii(_cloud(jvis, xyz), 50, 20, axis)
        assert len(art.split("\n")) == 20
    empty = np.full((3, 3), np.nan, np.float32)
    assert tvis.render_ascii(_cloud(tvis, empty)) == "(empty cloud)"


def test_plots_match_jax(tmp_path):
    rng = np.random.default_rng(42)
    x = np.cumsum(rng.normal(size=50))
    series = [(np.arange(50.0), x, "a"), (np.arange(50.0), x[::-1] * 2, "b"),
              (np.zeros(3), np.ones(3), "flat")]
    a, b = _both(tmp_path, "xy.svg", lambda m, p: m.plot_xy_svg(p, series, title="t"))
    assert a == b and a.startswith(b"<svg")
    h = rng.random(33)
    a, b = _both(tmp_path, "h.svg", lambda m, p: m.plot_histogram_svg(p, h, name="fpfh"))
    assert a == b
    feats = rng.random((5, 33))
    pt = tvis.histogram_visualizer_svg(str(tmp_path / "t_f"), feats, [0, 3])
    pj = jvis.histogram_visualizer_svg(str(tmp_path / "j_f"), feats, [0, 3])
    assert len(pt) == len(pj) == 2
    assert all(_read(p) == _read(q) for p, q in zip(pt, pj))


@pytest.mark.parametrize("case", ["ranges", "none_valid"])
def test_range_image_pgm_matches_jax(tmp_path, case):
    rng = np.random.default_rng(43)
    r = rng.uniform(0.5, 60.0, size=(30, 90)).astype(np.float32)
    r[rng.random(r.shape) < 0.2] = np.inf
    r[rng.random(r.shape) < 0.05] = np.nan
    r[0, :4] = [-1.0, 0.0, -np.inf, 3.0]
    if case == "none_valid":
        r[:] = np.inf
    a, b = _both(tmp_path, "r.pgm", lambda m, p: m.range_image_to_pgm(p, r))
    assert a == b and a.startswith(b"P5\n90 30\n255\n")
    img = np.frombuffer(a[len(b"P5\n90 30\n255\n"):], np.uint8).reshape(30, 90)
    assert (img[~(np.isfinite(r) & (r > 0))] == 255).all()


def _scene(pkg):
    rng = np.random.default_rng(44)
    vis = pkg.Visualizer("test window")
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    assert vis.add_point_cloud(_cloud(pkg, xyz), "map")
    assert not vis.add_point_cloud(_cloud(pkg, xyz), "map")
    vis.add_point_cloud(_cloud(pkg, xyz[:50] + 3, rng.random((50, 3)).astype(np.float32)), "rgb")
    vis.set_point_cloud_rendering_properties("point_size", 4, "map")
    vis.set_point_cloud_rendering_properties("opacity", 0.5, "rgb")
    assert vis.add_sphere([1, 2, 3], 0.5, "ball", color=(1, 0, 0))
    assert vis.add_line([0, 0, 0], [1, 1, 1], "l")
    assert vis.add_cube([0, 0, 0], [1, 2, 3], "box")
    assert vis.add_text3d("hello", [0, 0, 1], "t")
    vis.add_coordinate_system(2.0)
    vis.set_background_color(0.1, 0.2, 0.3)
    vis.set_camera_position((0, 0, 5), (0, 0, 0))
    return vis, xyz


def test_visualizer_frames_match_jax(tmp_path):
    t, xyz = _scene(tvis)
    j, _ = _scene(jvis)
    for a, b in zip(t._flatten(), j._flatten()):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    pt, pj = str(tmp_path / "t.html"), str(tmp_path / "j.html")
    assert t.spin_once(pt) == pt and j.spin_once(pj) == pj
    assert _read(pt) == _read(pj) and b"pcl_tpu_events.json" in _read(pt)
    assert t.spin_once() == j.spin_once()
    t.save_screenshot(str(tmp_path / "t.txt"))
    j.save_screenshot(str(tmp_path / "j.txt"))
    assert _read(tmp_path / "t.txt") == _read(tmp_path / "j.txt")
    assert t.remove_shape("ball") and not t.remove_shape("ball")
    assert t.remove_point_cloud("rgb") and t.contains("map") and not t.contains("rgb")
    with pytest.raises(ValueError):
        t.set_point_cloud_rendering_properties("shine", 1, "map")
    t.remove_all_point_clouds()
    assert not t.contains("map")


def test_visualizer_events_match_jax(tmp_path):
    events = [{"type": "key", "key": "a", "down": True, "ctrl": True},
              {"type": "pick", "index": 17, "x": 1.0, "y": 2.0, "z": 3.0},
              {"type": "mouse", "event": "release", "button": "right", "x": 4, "y": 5},
              {"type": "bogus"},
              {"type": "key", "key": "q"}]
    path = tmp_path / "events.json"
    path.write_text(json.dumps(events))
    logs = []
    for pkg in (tvis, jvis):
        vis, _ = _scene(pkg)
        log = []
        vis.register_keyboard_callback(lambda e: log.append(("key", e.get_key_sym(),
                                                             e.key_up(), e.ctrl)))
        off = vis.register_point_picking_callback(
            lambda e: log.append(("pick", e.get_point_index(), e.get_point())))
        vis.register_mouse_callback(lambda e: log.append(("mouse", e.type, e.button, e.x)))
        assert not vis.was_stopped()
        assert vis.dispatch_events(events) == 4
        assert vis.was_stopped()
        off()
        assert vis.dispatch_events(str(path)) == 4
        logs.append(log)
    assert logs[0] == logs[1]
    assert ("pick", 17, (1.0, 2.0, 3.0)) in logs[0]
    assert sum(1 for e in logs[0] if e[0] == "pick") == 1


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
        return r.read()


def test_live_viewer_get_and_post():
    vis, xyz = _scene(tvis)
    jv, _ = _scene(jvis)
    picks = []
    vis.register_point_picking_callback(lambda e: picks.append(e.get_point_index()))
    live = tvis.LiveViewer(vis, poll_timeout=2.0)
    try:
        page = _get(live.url).decode()
        from pcl_tpu.visualization import live as jlive
        assert page == jlive._PAGE
        frame = json.loads(_get(live.url + "frame?seq=0"))
        flat = jv._flatten()
        assert frame["seq"] == 1 and frame["n"] == len(flat[0]) and frame["info"] == flat[3]
        pts = np.frombuffer(base64.b64decode(frame["pts"]), np.float32).reshape(-1, 3)
        np.testing.assert_array_equal(pts, flat[0])
        got = {}
        poll = threading.Thread(target=lambda: got.update(
            json.loads(_get(live.url + "frame?seq=1"))))
        poll.start()
        vis.update_point_cloud(_cloud(tvis, xyz[:10]), "map")
        assert live.push(reset_view=True) == 2
        poll.join(timeout=TIMEOUT_S)
        assert not poll.is_alive() and got["seq"] == 2 and got["reset_view"]
        assert json.loads(_get(live.url + "frame?seq=99")) == {"seq": 99}
        req = urllib.request.Request(
            live.url + "events", method="POST", headers={"Content-Type": "application/json"},
            data=json.dumps([{"type": "pick", "index": 5, "x": 0, "y": 0, "z": 0}]).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            assert json.loads(r.read()) == {"dispatched": 1}
        assert picks == [5]
        with pytest.raises(urllib.error.HTTPError):
            _get(live.url + "nothing")
    finally:
        thread = live._thread
        live.close()
    assert not thread.is_alive()
