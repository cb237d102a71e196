"""pcl_tpu_torch.io against pcl_tpu.io on the CPU: PCD files and LZF streams
written by either package are read by the other, to the same arrays (exactly:
both parse the same bytes with numpy; ascii bodies keep 9 significant digits,
which round-trips float32)."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import io as pyio
import struct

import numpy as np
import pytest
import torch

from pcl_tpu import io as jio
from pcl_tpu.core import cloud as jcloud
from pcl_tpu.io import lzf as jlzf
from pcl_tpu.io import pcd as jpcd

from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core import cloud as tcloud
from pcl_tpu_torch.io import ascii as tascii
from pcl_tpu_torch.io import lzf as tlzf
from pcl_tpu_torch.io import pcd as tpcd
from pcl_tpu_torch.utils import timing

ENCODINGS = ["ascii", "binary", "binary_compressed"]


def _arrays(rng, n=300):
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    attrs = {"normal": nrm,
             "rgb": (rng.integers(0, 256, size=(n, 3)) / 255.0).astype(np.float32),
             "label": rng.integers(0, 50, size=n).astype(np.int32),
             "curvature": rng.uniform(size=n).astype(np.float32),
             "fpfh": rng.uniform(size=(n, 5)).astype(np.float32)}
    return xyz, attrs


def _assert_same(got_xyz, got_attrs, xyz, attrs):
    np.testing.assert_array_equal(got_xyz, xyz)
    assert set(got_attrs) == set(attrs)
    for k, v in attrs.items():
        if k == "rgb":       # stored as 8-bit channels
            np.testing.assert_allclose(got_attrs[k], v, atol=1e-6)
        else:
            np.testing.assert_array_equal(got_attrs[k], v)


@pytest.mark.parametrize("data", ENCODINGS)
def test_round_trip(rng, tmp_path, data):
    xyz, attrs = _arrays(rng)
    cloud = tcloud.from_numpy(xyz, attrs, capacity=320, device="cpu")
    path = tmp_path / "c.pcd"
    tio.save(path, cloud, data=data)
    back = tio.load(path, device="cpu")
    assert back.xyz.device.type == "cpu" and back.capacity == 300
    assert bool(back.mask.all()) and not back.is_organized
    _assert_same(*tcloud.to_numpy(back), xyz, attrs)
    assert back.attrs["label"].dtype == torch.int32
    h, cols = tpcd.read_pcd_arrays(path)
    assert h.data == data and h.points == 300 and h.width == 300 and h.height == 1
    assert h.fields[:6] == ["x", "y", "z", "normal_x", "normal_y", "normal_z"]
    assert h.counts[h.fields.index("fpfh")] == 5 and cols["fpfh"].shape == (300, 5)


@pytest.mark.parametrize("data", ENCODINGS)
def test_organized_round_trip(rng, tmp_path, data):
    xyz = rng.normal(size=(12 * 8, 3)).astype(np.float32)
    cloud = tcloud.from_numpy(xyz, width=12, height=8, device="cpu")
    path = tmp_path / "o.pcd"
    tio.save(path, cloud, data=data)
    back = tio.load(path, device="cpu")
    assert (back.width, back.height, back.capacity) == (12, 8, 96)
    np.testing.assert_array_equal(back.xyz.numpy(), xyz)
    want = jpcd.load(path)
    assert (want.width, want.height) == (12, 8)
    np.testing.assert_array_equal(np.asarray(want.xyz), back.xyz.numpy())


def test_nonfinite_rows_of_an_organized_file(tmp_path):
    """A sensor's NaN returns keep their rows (width and height stay valid)
    and are masked; an unorganized file keeps them only with keep_invalid."""
    rows = ["1 2 3", "nan nan nan", "4 5 6", "7 inf 9", "1 1 1", "2 2 2"]
    path = tmp_path / "n.pcd"
    path.write_text(_header(WIDTH="3", HEIGHT="2", POINTS="6") + "\n".join(rows) + "\n")
    got, want = tpcd.load(path, device="cpu"), jpcd.load(path)
    assert (got.width, got.height, got.capacity) == (3, 2, 6)
    assert got.mask.tolist() == [True, False, True, False, True, True]
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    kept = tpcd.load(path, keep_invalid=True, capacity=8, device="cpu")
    assert kept.capacity == 8 and int(kept.count) == 6


@pytest.mark.parametrize("data", ENCODINGS)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_cross_packages(rng, tmp_path, data, writer):
    xyz, attrs = _arrays(rng)
    path = tmp_path / "x.pcd"
    if writer == "jax":
        jpcd.save(path, jcloud.from_numpy(xyz, attrs), data=data)
        got = tcloud.to_numpy(tpcd.load(path, device="cpu"))
    else:
        tpcd.save(path, tcloud.from_numpy(xyz, attrs, device="cpu"), data=data)
        got = jcloud.to_numpy(jpcd.load(path))
    _assert_same(np.asarray(got[0]), {k: np.asarray(v) for k, v in got[1].items()},
                 xyz, attrs)
    # and the two writers put the same bytes on disk
    other = tmp_path / "y.pcd"
    if writer == "jax":
        tpcd.save(other, tcloud.from_numpy(xyz, attrs, device="cpu"), data=data)
        assert other.read_bytes() == path.read_bytes()


def _payloads(rng):
    return [b"", b"a", b"ab" * 3, bytes(rng.integers(0, 256, size=5000, dtype=np.uint8)),
            bytes(1000), np.arange(3000, dtype=np.float32).tobytes(),
            (b"abcabcabd" * 400)[:-1]]


@pytest.mark.parametrize("enc", ["c", "py", "jax"])
@pytest.mark.parametrize("dec", ["c", "py", "jax"])
def test_lzf_streams_cross(rng, enc, dec):
    assert tlzf._lib() is not None, "the C codec did not build here"
    compress = {"c": tlzf.compress, "py": tlzf._compress_py, "jax": jlzf.compress}[enc]
    decompress = {"c": tlzf.decompress, "py": tlzf._decompress_py,
                  "jax": jlzf.decompress}[dec]
    for blob in _payloads(rng):
        if not blob and (enc, dec) != ("py", "py"):
            continue        # the C codecs refuse an empty buffer in both packages
        assert decompress(compress(blob), len(blob)) == blob
    if enc == "c":
        big = _payloads(rng)[5]
        assert len(compress(big)) < len(big)
        assert compress(big) == jlzf.compress(big)


@pytest.mark.parametrize("codec", ["c", "py"])
def test_lzf_rejects_malformed(codec):
    dec = tlzf.decompress if codec == "c" else tlzf._decompress_py
    good = tlzf.compress(b"hello hello hello hello")
    with pytest.raises(ValueError):
        dec(good, 5)                                   # too short an output
    with pytest.raises(ValueError):
        dec(good[:-2], 23)                             # truncated stream
    with pytest.raises(ValueError):
        dec(bytes([0x20, 0x05]), 10)                   # reference before the start


def test_lzf_python_codec_where_no_compiler(monkeypatch, rng):
    """Without a C compiler the codec is the Python one, and files still
    round-trip."""
    from pcl_tpu_torch.ops import _build

    def no_compiler(name):
        raise RuntimeError("no compiler")

    tlzf._lib.cache_clear()
    monkeypatch.setattr(_build, "host_library", no_compiler)
    try:
        assert tlzf._lib() is None
        blob = _payloads(rng)[3]
        stream = tlzf.compress(blob)
        assert stream == tlzf._compress_py(blob)
        assert tlzf.decompress(stream, len(blob)) == blob
        assert jlzf.decompress(stream, len(blob)) == blob
    finally:
        tlzf._lib.cache_clear()


def _header(**over):
    h = {"FIELDS": "x y z", "SIZE": "4 4 4", "TYPE": "F F F", "COUNT": "1 1 1",
         "WIDTH": "2", "HEIGHT": "1", "POINTS": "2", "DATA": "ascii"}
    h.update(over)
    return "".join(f"{k} {v}\n" for k, v in h.items() if v is not None)


@pytest.mark.parametrize("text,match", [
    ("VERSION 0.7\nFIELDS x y z\n", "unexpected EOF"),
    (_header(WIDTH=""), "has no value"),
    ("BOGUS 1\n" + _header(), "unknown header key"),
    (_header(SIZE="4 4"), "length mismatch"),
    (_header(POINTS="-2", WIDTH="-2"), "negative"),
    (_header(COUNT="1 0 1"), "non-positive"),
    (_header(FIELDS="a b c") + "1 2 3\n4 5 6\n", "no x/y/z"),
    (_header() + "1 2 3\n4 5\n", "expected 6 values"),
    (_header(DATA="zip") + "1 2 3\n", "unsupported DATA"),
])
def test_header_errors(text, match):
    with pytest.raises(ValueError, match=match):
        tpcd.load(pyio.BytesIO(text.encode()), device="cpu")
    with pytest.raises(ValueError, match=match):
        jpcd.load(pyio.BytesIO(text.encode()))


@pytest.mark.parametrize("body,match", [
    (b"\x01\x02", "truncated size header"),
    (struct.pack("<II", 4, 999) + b"abcd", "uncompressed size"),
    (struct.pack("<II", 400, 24) + b"abcd", "truncated body"),
])
def test_compressed_body_errors(body, match):
    blob = _header(DATA="binary_compressed").encode() + body
    with pytest.raises(ValueError, match=match):
        tpcd.load(pyio.BytesIO(blob), device="cpu")
    with pytest.raises(ValueError, match="truncated body"):
        tpcd.load(pyio.BytesIO(_header(DATA="binary").encode() + b"abc"), device="cpu")


def test_save_rejects_unknown_encoding(tmp_path):
    c = tcloud.make_cloud(np.zeros((2, 3)), device="cpu")
    with pytest.raises(ValueError, match="unsupported DATA"):
        tpcd.save(tmp_path / "c.pcd", c, data="zip")


def test_dispatch_by_extension(rng, tmp_path):
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    cloud = tcloud.make_cloud(xyz, capacity=64, device="cpu")
    for name in ("c.xyz", "c.txt", "c.PCD", "c.ply"):
        tio.save(tmp_path / name, cloud)
        back = tio.load(tmp_path / name, device="cpu")
        np.testing.assert_array_equal(tcloud.to_numpy(back)[0], xyz)
    for name in ("c.xyz", "c.ply"):
        want = jio.load(str(tmp_path / name))
        np.testing.assert_array_equal(np.asarray(jcloud.to_numpy(want)[0]), xyz)
    # the formats of slice 14: .ifs and .vtk both ways, .obj read only (its
    # save raises ImportError in both packages, ROADMAP C86)
    for ext in (".ifs", ".vtk"):
        tio.save(tmp_path / f"c{ext}", cloud)
        back = tio.load(tmp_path / f"c{ext}", device="cpu")
        want = np.asarray(jcloud.to_numpy(jio.load(str(tmp_path / f"c{ext}")))[0])
        np.testing.assert_array_equal(tcloud.to_numpy(back)[0], want)
    with pytest.raises(ImportError):
        tio.save(tmp_path / "c.obj", cloud)
    with pytest.raises(ValueError, match="unknown point-cloud file extension"):
        tio.load(tmp_path / "c.bin")


@pytest.mark.parametrize("ncol,attr", [(4, "intensity"), (6, "rgb"), (8, "extra")])
def test_ascii_columns(rng, tmp_path, ncol, attr):
    data = rng.uniform(size=(20, ncol)).astype(np.float32)
    np.savetxt(tmp_path / "a.txt", data, fmt="%.9g")
    got = tascii.load(tmp_path / "a.txt", device="cpu")
    want = jio.load(str(tmp_path / "a.txt"))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    np.testing.assert_array_equal(got.attrs[attr].numpy(), np.asarray(want.attrs[attr]))
    if ncol == 6:
        nrm = tascii.load(tmp_path / "a.txt", columns=("x", "y", "z", "nx", "ny", "nz"),
                          device="cpu")
        assert "normal" in nrm.attrs
    with pytest.raises(ValueError, match=">= 3 columns"):
        np.savetxt(tmp_path / "b.txt", data[:, :2])
        tascii.load(tmp_path / "b.txt", device="cpu")


def test_load_defaults_to_the_card(monkeypatch, tmp_path):
    tio.save(tmp_path / "c.pcd", tcloud.make_cloud(np.zeros((3, 3)), device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load(tmp_path / "c.pcd")


def test_timing_helpers():
    sw = timing.StopWatch()
    assert sw.seconds() >= 0 and sw.ms() >= 0
    lines = []
    with timing.ScopeTime("t", printer=lines.append) as st:
        pass
    assert st.elapsed_ms >= 0 and lines[0].startswith("[ScopeTime] t: ")
    ef = timing.EventFrequency(window=3)
    assert ef.frequency() == 0.0
    for _ in range(5):
        ef.event()
    assert len(ef._stamps) == 3 and ef.frequency() > 0
