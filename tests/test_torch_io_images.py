"""Parity of the port's image and mesh file formats with the JAX package.

Tolerances: none — every writer's file is byte for byte the JAX writer's
(the tar's members compared as the clouds they hold, each written by its
own package's PCD writer), and every reader returns the JAX reader's arrays
bit for bit, on files written by either package and on PNG rows with each
of the five filter types. Extension dispatch of ``io.load``/``io.save``
covers every extension the JAX package's does; saving ``.obj`` raises
``ImportError`` in both (ROADMAP C86).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import struct
import zlib

import numpy as np
import pytest

from pcl_tpu import io as jio
from pcl_tpu.core.cloud import from_numpy as jfrom, to_numpy as jto
from pcl_tpu.io import formats_extra as jfx
from pcl_tpu.io import obj as jobj
from pcl_tpu.io import png as jpng
from pcl_tpu.io import tiff as jtiff

from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core.cloud import from_numpy, make_cloud, to_numpy
from pcl_tpu_torch.io import formats_extra as tfx
from pcl_tpu_torch.io import obj as tobj
from pcl_tpu_torch.io import png as tpng
from pcl_tpu_torch.io import tiff as ttiff


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _images(rng):
    return {
        "grey8": rng.integers(0, 256, (13, 17)).astype(np.uint8),
        "grey16": rng.integers(0, 65536, (13, 17)).astype(np.uint16),
        "rgb": rng.integers(0, 256, (9, 11, 3)).astype(np.uint8),
        "rgba": rng.integers(0, 256, (9, 11, 4)).astype(np.uint8),
    }


@pytest.mark.parametrize("kind", ["grey8", "grey16", "rgb", "rgba"])
def test_png_bytes_and_reads_match_jax(kind, tmp_path):
    img = _images(np.random.default_rng(0))[kind]
    a, b = tmp_path / "t.png", tmp_path / "j.png"
    tpng.save_png(str(a), img)
    jpng.save_png(str(b), img)
    assert _bytes(a) == _bytes(b)
    got, want = tpng.load_png(str(b)), jpng.load_png(str(a))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


def _filtered_png(path, img, ftype):
    """A PNG of 8-bit ``img`` whose rows all use filter ``ftype``, encoded
    as the PNG specification defines each filter."""
    img = np.asarray(img, np.uint8)
    H = img.shape[0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(H, -1).astype(np.int64)
    prev = np.zeros_like(rows[0])
    body = b""
    for r in rows:
        a = np.concatenate([np.zeros(ch, np.int64), r[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        if ftype == 0:
            pred = np.zeros_like(r)
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        body += bytes([ftype]) + ((r - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = r
    ct = {1: 0, 3: 2, 4: 6}[ch]
    ihdr = struct.pack(">IIBBBBB", img.shape[1], H, 8, ct, 0, 0, 0)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(body))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["grey8", "rgb"])
def test_png_reads_every_filter_type(ftype, kind, tmp_path):
    img = _images(np.random.default_rng(ftype))[kind]
    p = str(tmp_path / "f.png")
    _filtered_png(p, img, ftype)
    np.testing.assert_array_equal(tpng.load_png(p), jpng.load_png(p))
    np.testing.assert_array_equal(tpng.load_png(p), img)


def test_depth_and_rgb_png_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    depth = rng.uniform(0, 7, (12, 16)).astype(np.float32)
    depth[2, 3] = np.nan
    depth[4, 5] = 70.0                               # beyond 65.535 m: clipped
    rgb = rng.uniform(-0.1, 1.1, (12, 16, 3)).astype(np.float32)
    for save_t, save_j, load_t, load_j, x in (
            (tpng.save_depth_png, jpng.save_depth_png, tpng.load_depth_png,
             jpng.load_depth_png, depth),
            (tpng.save_rgb_png, jpng.save_rgb_png, tpng.load_rgb_png, jpng.load_rgb_png, rgb)):
        a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        save_t(a, x)
        save_j(b, x)
        assert _bytes(a) == _bytes(b)
        np.testing.assert_array_equal(load_t(a), load_j(b))
    with pytest.raises(ValueError, match="unsupported image shape"):
        tpng.save_png(str(tmp_path / "c.png"), np.zeros((4, 4, 2), np.uint8))
    with open(tmp_path / "x.png", "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tpng.load_png(str(tmp_path / "x.png"))


@pytest.mark.parametrize("kind", ["grey8", "grey16", "rgb"])
def test_tiff_bytes_and_reads_match_jax(kind, tmp_path):
    img = _images(np.random.default_rng(2))[kind]
    a, b = tmp_path / "t.tif", tmp_path / "j.tif"
    ttiff.save_tiff(str(a), img)
    jtiff.save_tiff(str(b), img)
    assert _bytes(a) == _bytes(b)
    got, want = ttiff.load_tiff(str(b)), jtiff.load_tiff(str(a))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


def test_tiff_big_endian_strips_and_refusals(tmp_path):
    """A big-endian 16-bit TIFF in two strips, written here by hand."""
    img = np.random.default_rng(3).integers(0, 65536, (6, 5)).astype(np.uint16)
    body = img.astype(">u2").tobytes()
    half = len(body) // 2
    entries = [(256, 4, 1, 5), (257, 4, 1, 6), (258, 3, 1, 16 << 16), (259, 3, 1, 1 << 16),
               (262, 3, 1, 1 << 16), (273, 4, 2, None), (277, 3, 1, 1 << 16),
               (278, 4, 1, 3), (279, 4, 2, None)]
    ifd_size = 2 + 12 * len(entries) + 4
    arrays_at = 8 + ifd_size
    data_at = arrays_at + 16
    ifd = struct.pack(">H", len(entries))
    for tag, typ, cnt, val in entries:
        if tag == 273:
            val = arrays_at
        elif tag == 279:
            val = arrays_at + 8
        ifd += struct.pack(">HHII", tag, typ, cnt, val)
    ifd += struct.pack(">I", 0)
    arrays = struct.pack(">II", data_at, data_at + half) + struct.pack(">II", half,
                                                                       len(body) - half)
    p = tmp_path / "be.tif"
    p.write_bytes(struct.pack(">2sHI", b"MM", 42, 8) + ifd + arrays + body)
    np.testing.assert_array_equal(ttiff.load_tiff(str(p)), jtiff.load_tiff(str(p)))
    np.testing.assert_array_equal(ttiff.load_tiff(str(p)), img)
    (tmp_path / "x.tif").write_bytes(b"XX" + b"\0" * 10)
    for mod in (ttiff, jtiff):
        with pytest.raises(ValueError, match="not a TIFF"):
            mod.load_tiff(str(tmp_path / "x.tif"))


OBJ = """# a quad, a pentagon, texture and normal indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 2 0.5 0.25
v 2 1.5 0.5
vt 0 0
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0.6 0.8
vn 0.6 0 0.8
f 1/1/1 2/1/2 3/1/3 4/1/4
f 2//2 5//5 6//6 3//3 4//4

f 1 3 4
"""


@pytest.mark.parametrize("normals", [True, False])
def test_obj_reader_matches_jax(normals, tmp_path):
    text = OBJ if normals else "\n".join(ln for ln in OBJ.splitlines()
                                         if not ln.startswith("vn 0.6"))
    p = tmp_path / "m.obj"
    p.write_text(text)
    tc, tf = tobj.load_mesh(str(p), device="cpu")
    jc, jf = jobj.load_mesh(str(p))
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape == (2 + 3 + 1, 3)
    (txyz, tat), (jxyz, jat) = to_numpy(tc), jto(jc)
    np.testing.assert_array_equal(txyz, np.asarray(jxyz))
    assert sorted(tat) == sorted(jat) == (["normal"] if normals else [])
    for k in tat:
        np.testing.assert_array_equal(tat[k], np.asarray(jat[k]))
    np.testing.assert_array_equal(to_numpy(tobj.load(str(p), capacity=8, device="cpu"))[0],
                                  txyz)


def test_ifs_and_vtk_bytes_and_reads_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    f = rng.integers(0, 40, (25, 3)).astype(np.int32)
    for name, tsave, jsave, tload, jload in (
            ("m.ifs", lambda p, *a: tfx.save_ifs(p, *a, name="m"),
             lambda p, *a: jfx.save_ifs(p, *a, name="m"), tfx.load_ifs, jfx.load_ifs),
            ("m.vtk", tfx.save_vtk, jfx.save_vtk, tfx.load_vtk, jfx.load_vtk)):
        for faces in (f, None):
            a, b = str(tmp_path / ("t" + name)), str(tmp_path / ("j" + name))
            tsave(a, v, faces)
            jsave(b, v, faces)
            assert _bytes(a) == _bytes(b)
            (tv, tf), (jv, jf) = tload(b), jload(a)
            np.testing.assert_array_equal(tv, jv)
            if faces is None and name == "m.ifs":
                assert tf is None and jf is None
            else:
                np.testing.assert_array_equal(tf, jf)
    tc = tfx.load_vtk_cloud(str(tmp_path / "jm.vtk"), device="cpu")
    np.testing.assert_array_equal(tc.xyz.numpy(), np.asarray(jfx.load_vtk_cloud(
        str(tmp_path / "tm.vtk")).xyz))
    tc = tfx.load_ifs_cloud(str(tmp_path / "jm.ifs"), device="cpu")
    np.testing.assert_array_equal(tc.xyz.numpy(), v)


def test_tar_of_pcds_round_trips_beside_jax(tmp_path):
    rng = np.random.default_rng(5)
    clouds = [rng.normal(size=(n, 3)).astype(np.float32) for n in (30, 1, 57)]
    a, b = str(tmp_path / "t.tar"), str(tmp_path / "j.tar")
    tfx.save_tar_pcds(a, [from_numpy(x, device="cpu") for x in clouds], prefix="scan")
    jfx.save_tar_pcds(b, [jfrom(x) for x in clouds], prefix="scan")
    got = tfx.load_tar_pcds(b, device="cpu")
    want = jfx.load_tar_pcds(a)
    assert len(got) == len(want) == 3
    for g, w, x in zip(got, want, clouds):
        np.testing.assert_array_equal(to_numpy(g)[0], x)
        np.testing.assert_array_equal(np.asarray(jto(w)[0]), x)


def test_dispatch_covers_the_jax_extensions(tmp_path):
    xyz = np.random.default_rng(6).normal(size=(20, 3)).astype(np.float32)
    tc, jc = make_cloud(xyz, device="cpu"), jfrom(xyz)
    for ext in (".pcd", ".ply", ".xyz", ".txt", ".ifs", ".vtk"):
        a, b = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
        tio.save(a, tc)
        jio.save(b, jc)
        if ext in (".ifs", ".vtk"):
            assert _bytes(a) == _bytes(b)
        got = to_numpy(tio.load(b, device="cpu"))[0]
        want = np.asarray(jto(jio.load(a))[0])
        np.testing.assert_allclose(got, want, rtol=1e-5 if ext == ".vtk" else 0, atol=0)
    (tmp_path / "m.obj").write_text(OBJ)
    np.testing.assert_array_equal(to_numpy(tio.load(str(tmp_path / "m.obj"), device="cpu"))[0],
                                  np.asarray(jto(jio.load(str(tmp_path / "m.obj")))[0]))
    with pytest.raises(ImportError):
        jio.save(str(tmp_path / "j.obj"), jc)
    with pytest.raises(ImportError):
        tio.save(str(tmp_path / "t.obj"), tc)
    for mod, c in ((tio, tc), (jio, jc)):
        with pytest.raises(ValueError, match="unknown point-cloud file extension"):
            mod.save(str(tmp_path / "c.bin"), c)
