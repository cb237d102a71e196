"""The port's grabbers and sensor codecs beside the JAX package's on the same
numpy inputs, made from a seed: Velodyne packet decoding (VLP-16 and
HDL-32E), the pcap writer and reader, the sweep split (also where packets
straddle 0 deg), the PCD, image and TiM grabbers, and ``CloudIterator``.

Tolerances: none where both packages run the same numpy code (packets,
pcap bytes, decoded points, sweeps, TiM points): equal bit for bit.
``ImageGrabber``'s vertex maps are the port's ``depth_to_vertex_map`` beside
the JAX package's on the same depth: equal bit for bit (one rounding per
operation, in the same order). Every grabber thread a test starts is joined
before it ends, and every wait is bounded (``WAIT_S``).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import threading
import time

import numpy as np
import pytest

from pcl_tpu.core.cloud import from_numpy as jfrom
from pcl_tpu.core.cloud import to_numpy as jto
from pcl_tpu.io import grabber as jgrab
from pcl_tpu.io import pcd as jpcd
from pcl_tpu.io import tim as jtim
from pcl_tpu.io import velodyne as jvel

from pcl_tpu_torch.core.cloud import to_numpy
from pcl_tpu_torch.io import grabber as tgrab
from pcl_tpu_torch.io import tim as ttim
from pcl_tpu_torch.io import velodyne as tvel

WAIT_S = 10.0


def _packets(rng, n_blocks, step_deg, start_deg=0.0, drop=0.1):
    """Packets of 12 blocks at azimuths ``start + k step`` (wrapping at 360),
    random distances (2 mm units, some 0) and intensities."""
    out = []
    for p in range(-(-n_blocks // 12)):
        az = (start_deg + step_deg * (12 * p + np.arange(12))) % 360.0
        dist = rng.uniform(1.0, 100.0, size=(12, 32))
        dist[rng.random((12, 32)) < drop] = 0.0
        out.append(tvel.encode_packet(az, dist, rng.integers(0, 256, size=(12, 32))))
    return out


@pytest.mark.parametrize("model", ["VLP16", "HDL32E"])
def test_decode_packet_matches_jax(model):
    rng = np.random.default_rng(20)
    for pkt in _packets(rng, 12 * 20, 0.37, start_deg=355.0):
        a, b = tvel.decode_packet(pkt, model), jvel.decode_packet(pkt, model)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_decode_packet_layout():
    """One return per non-zero distance at the block's azimuth; the range is
    the 2 mm unit's; a block without the 0xEEFF flag is dropped."""
    rng = np.random.default_rng(21)
    dist = rng.uniform(1.0, 50.0, size=(12, 32))
    dist[0, :5] = 0.0
    az = np.arange(12) * 30.0
    pkt = bytearray(tvel.encode_packet(az, dist, np.full((12, 32), 7)))
    assert tvel.encode_packet(az, dist, np.full((12, 32), 7)) == \
        jvel.encode_packet(az, dist, np.full((12, 32), 7))
    pkt[100 * 3] = 0                                    # block 3 loses its flag
    xyz, inten, a = tvel.decode_packet(bytes(pkt), "HDL32E")
    assert len(xyz) == 12 * 32 - 5 - 32
    q = np.round(dist / 0.002) * 0.002
    keep = np.ones((12, 32), bool)
    keep[0, :5] = False
    keep[3] = False
    np.testing.assert_allclose(np.linalg.norm(xyz, axis=1), q[keep], rtol=2e-7, atol=1e-6)
    np.testing.assert_array_equal(inten, 7.0)
    np.testing.assert_array_equal(a, np.broadcast_to(az[:, None], (12, 32))[keep])
    with pytest.raises(ValueError):
        tvel.decode_packet(bytes(pkt[:-1]))
    with pytest.raises(ValueError):
        tvel.decode_packet(bytes(pkt), "HDL64")


def test_pcap_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(22)
    pkts = _packets(rng, 12 * 30, 1.3)
    a, b = str(tmp_path / "a.pcap"), str(tmp_path / "b.pcap")
    tvel.write_pcap(a, pkts)
    jvel.write_pcap(b, pkts)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert list(tvel.read_pcap_packets(b)) == pkts == list(jvel.read_pcap_packets(a))
    bad = str(tmp_path / "bad.pcap")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 24)
    with pytest.raises(ValueError, match="not a pcap"):
        list(tvel.read_pcap_packets(bad))


def _sweeps(grabber_cls, path, model):
    g = grabber_cls(path, model=model, **({"device": "cpu"} if grabber_cls is
                                           tvel.PcapVelodyneGrabber else {}))
    out = []
    for c in g._sweeps():
        xyz, attrs = (to_numpy if grabber_cls is tvel.PcapVelodyneGrabber else jto)(c)
        out.append((xyz, attrs["intensity"]))
    return out


@pytest.mark.parametrize("case", ["padded", "straddling", "one_revolution", "half_wrap"])
def test_sweep_split_matches_jax(tmp_path, case):
    """Revolutions of 0.4 deg blocks. ``padded``: each revolution starts a
    new packet (its last packet padded with empty blocks), one sweep per
    revolution. ``straddling``: packets straddle 0 deg; the JAX grabber
    splits only between packets, where a packet's first azimuth lies more
    than 180 deg below the last one before it, so a straddling packet
    keeps the next revolution's first blocks and the next packet starts no
    new sweep: the port gives the JAX grabber's sweeps, whatever their
    count."""
    rng = np.random.default_rng(23)
    path = str(tmp_path / f"{case}.pcap")
    if case == "padded":
        pkts = []
        for _ in range(3):
            rev = _packets(rng, 900, 0.4)                   # 75 packets, 900 blocks
            rev[-1] = tvel.encode_packet(np.arange(12) * 0.4 + 355.2, np.zeros((12, 32)),
                                         np.zeros((12, 32)))
            pkts += rev
        expect = 3
    elif case == "straddling":
        pkts = _packets(rng, 12 * 200, 0.4, start_deg=10.0)  # 960 deg
        expect = None
    elif case == "one_revolution":
        pkts = _packets(rng, 12 * 70, 0.4, start_deg=20.0)
        expect = 1
    else:
        pkts = _packets(rng, 12 * 60, 0.8, start_deg=300.0)
        expect = None
    tvel.write_pcap(path, pkts)
    for model in ("VLP16", "HDL32E"):
        a = _sweeps(tvel.PcapVelodyneGrabber, path, model)
        b = _sweeps(jvel.PcapVelodyneGrabber, path, model)
        assert len(a) == len(b) and (expect is None or len(a) == expect)
        for (xa, ia), (xb, ib) in zip(a, b):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ia, ib)
    if case == "straddling":
        assert len(a) < 960 // 360 + 1


def _wait(cond):
    t0 = time.perf_counter()
    while not cond() and time.perf_counter() - t0 < WAIT_S:
        time.sleep(0.01)
    return cond()


def test_velodyne_grabber_pump_and_iterator(tmp_path):
    """The callback pump, ``frames()`` and ``CloudIterator`` give the same
    sweeps; every thread is joined."""
    rng = np.random.default_rng(24)
    pkts = []
    for _ in range(4):
        rev = _packets(rng, 900, 0.4)
        rev[-1] = tvel.encode_packet(np.arange(12) * 0.4 + 355.2, np.zeros((12, 32)),
                                     np.zeros((12, 32)))
        pkts += rev
    path = str(tmp_path / "drive.pcap")
    tvel.write_pcap(path, pkts)
    ref = [to_numpy(c)[0] for c in
           tvel.PcapVelodyneGrabber(path, "VLP16", device="cpu").frames()]
    assert len(ref) == 4
    got = []
    g = tvel.PcapVelodyneGrabber(path, "VLP16", device="cpu")
    g.register_callback(lambda c: got.append(to_numpy(c)[0]))
    g.start()
    assert _wait(lambda: len(got) == 4 and not g.is_running())
    thread = g._thread
    g.stop()
    assert g._thread is None and not thread.is_alive()
    g2 = tvel.PcapVelodyneGrabber(path, "VLP16", device="cpu")
    it = [to_numpy(c)[0] for c in tgrab.CloudIterator(g2)]
    thread = g2._thread
    g2.stop()
    assert not thread.is_alive()
    for a, b, c in zip(ref, got, it):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(got) == len(it) == 4
    unregister = g2.register_callback(print)
    unregister()
    assert print not in g2._callbacks


def test_callback_exception_ends_the_pump(tmp_path):
    """As in the JAX package, a callback that raises ends the pump thread
    (``threading`` prints the exception): frames after it never arrive, so
    a caller that must see every frame counts them."""
    paths = []
    for k in range(3):
        p = str(tmp_path / f"f{k}.pcd")
        jpcd.save(p, jfrom(np.full((5, 3), k, np.float32)))
        paths.append(p)
    seen = []

    def cb(c):
        seen.append(int(c.count))
        raise RuntimeError("callback failed")

    g = tgrab.PCDGrabber(paths, device="cpu")
    g.register_callback(cb)
    hook, threading.excepthook = threading.excepthook, lambda args: None
    try:
        g.start()
        assert _wait(lambda: not g._thread.is_alive())
    finally:
        threading.excepthook = hook
    g.stop()
    assert seen == [5]


@pytest.mark.parametrize("repeat", [False, True])
def test_pcd_grabber_matches_jax(tmp_path, repeat):
    rng = np.random.default_rng(25)
    d = tmp_path / "seq"
    d.mkdir()
    for k in range(3):
        jpcd.save(str(d / f"s{k}.pcd"), jfrom(rng.normal(size=(50 + k, 3)).astype(np.float32)))
    a = tgrab.PCDGrabber(str(d), repeat=repeat, device="cpu")
    b = jgrab.PCDGrabber(str(d), repeat=repeat)
    assert a.paths == b.paths
    fa, fb = a.frames(), b.frames()
    for _ in range(5 if repeat else 3):
        np.testing.assert_array_equal(to_numpy(next(fa))[0], jto(next(fb))[0])
    fa.close()
    fb.close()
    if not repeat:
        assert len(list(tgrab.PCDGrabber(str(d), device="cpu").frames())) == 3
    single = tgrab.PCDGrabber(str(d / "s1.pcd"), device="cpu")
    assert single.paths == [str(d / "s1.pcd")]


def test_pcd_grabber_fps(tmp_path):
    p = str(tmp_path / "one.pcd")
    jpcd.save(p, jfrom(np.zeros((4, 3), np.float32)))
    g = tgrab.PCDGrabber([p, p, p], fps=20.0, device="cpu")
    t0 = time.perf_counter()
    assert len(list(g.frames())) == 3
    assert time.perf_counter() - t0 >= 3 * 0.05 * 0.9


def test_image_grabber_matches_jax(tmp_path):
    rng = np.random.default_rng(26)
    d = tmp_path / "depth"
    d.mkdir()
    frames = []
    for k in range(3):
        z = rng.uniform(0.5, 4.0, size=(24, 32)).astype(np.float32)
        z[rng.random(z.shape) < 0.1] = 0.0
        np.save(str(d / f"d{k:03d}.npy"), z)
        frames.append(z)
    a = list(tgrab.ImageGrabber(str(d), focal=40.0, device="cpu").frames())
    b = list(jgrab.ImageGrabber(str(d), focal=40.0).frames())
    assert len(a) == len(b) == 3
    for ca, cb, z in zip(a, b, frames):
        assert (ca.width, ca.height) == (cb.width, cb.height) == (32, 24)
        np.testing.assert_array_equal(ca.mask.numpy(), np.asarray(cb.mask))
        np.testing.assert_array_equal(ca.xyz.numpy(), np.asarray(cb.xyz))
        np.testing.assert_array_equal(ca.mask.numpy(), (z > 0).reshape(-1))
        np.testing.assert_array_equal(ca.xyz.numpy()[:, 2], z.reshape(-1))


HEADER = ("sRA LMDscandata 1 1 1291B11 0 0 AED5 AED7 FDB36397 FDB3779F "
          "0 0 1 0 0 5DC A2 0 1 DIST1 3F800000 00000000 FFF92230 D05")


def _tim_packet(rng, n):
    mm = (rng.uniform(0.05, 20.0, n) * 1000).astype(np.int64)
    return HEADER + " " + " ".join(f"{v:X}" for v in [n] + mm.tolist())


def test_tim_parse_and_replay_match_jax(tmp_path):
    rng = np.random.default_rng(27)
    pkts = [_tim_packet(rng, n) for n in (811, 1, 3, 400)]
    for p in pkts:
        np.testing.assert_array_equal(ttim.parse_tim_packet(p), jtim.parse_tim_packet(p))
    for framed in (True, False):
        path = tmp_path / f"log{framed}.txt"
        path.write_text("\x02" + "\x03\x02".join(pkts) + "\x03" if framed else "\n".join(pkts))
        a, b = ttim.load_tim_log(str(path)), jtim.load_tim_log(str(path))
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    got = []
    g = ttim.TimGrabber(str(path), device="cpu")
    g.register_callback(lambda c: got.append(to_numpy(c)[0]))
    g.start()
    assert _wait(lambda: len(got) == 4)
    thread = g._thread
    g.stop()
    assert not thread.is_alive()
    for x, y in zip(got, jtim.load_tim_log(str(path))):
        np.testing.assert_array_equal(x, y)
    for bad in ("sRA LMDscandata 1 2 3", _tim_packet(rng, 0)):   # no space after the count
        for parse in (ttim.parse_tim_packet, jtim.parse_tim_packet):
            with pytest.raises(ValueError, match="truncated"):
                parse(bad)
    with pytest.raises(ValueError, match="samples"):
        ttim.parse_tim_packet(HEADER + " 5 1 2")


def test_cloud_iterator_backpressure(tmp_path):
    """A queue of two: the pump blocks until the consumer takes a frame;
    all six frames arrive in order and the iterator ends by itself."""
    paths = []
    for k in range(6):
        p = str(tmp_path / f"f{k}.pcd")
        jpcd.save(p, jfrom(np.full((3, 3), k, np.float32)))
        paths.append(p)
    g = tgrab.PCDGrabber(paths, device="cpu")
    it = tgrab.CloudIterator(g, maxsize=2)
    seen = []
    for c in it:
        seen.append(float(c.xyz[0, 0]))
        time.sleep(0.02)
    thread = g._thread
    g.stop()
    assert not thread.is_alive()
    assert seen == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
