"""Parity of pcl_tpu_torch.io.ply with pcl_tpu.io.ply on the CPU: each
package reads what either wrote, in ascii, binary_little_endian and
binary_big_endian, with normals, colours, other attributes and faces; the
header parser and the body-size guard reject the same malformed files.

Binary bodies round trip bit for bit; ascii bodies carry 9 significant
digits, which float32 values survive exactly, so every comparison is exact.
The port converts big-endian columns to native order (torch, like jnp,
takes no other); the JAX reader does so only for points, normals and
colours.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core import cloud as jcloud
from pcl_tpu.io import ply as jply

from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core import cloud as tcloud
from pcl_tpu_torch.io import ply as tply

FORMATS = [dict(binary=False), dict(binary=True, byte_order="little"),
           dict(binary=True, byte_order="big")]


def _arrays(seed, n=257):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(scale=20.0, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = (rng.integers(0, 256, size=(n, 3)) / 255.0).astype(np.float32)
    inten = rng.random(n).astype(np.float32)
    label = rng.integers(0, 9, n).astype(np.int32)
    return xyz, dict(normal=nrm, rgb=rgb, intensity=inten, label=label)


def _same_cloud(t, j):
    txyz, tattrs = tcloud.to_numpy(t)
    jxyz, jattrs = jcloud.to_numpy(j)
    np.testing.assert_array_equal(txyz, np.asarray(jxyz))
    assert set(tattrs) == set(jattrs)
    for k in tattrs:
        np.testing.assert_array_equal(tattrs[k], np.asarray(jattrs[k]))


@pytest.mark.parametrize("fmt", FORMATS, ids=["ascii", "binary_little", "binary_big"])
def test_round_trips_match_jax(tmp_path, fmt):
    xyz, attrs = _arrays(0)
    if fmt.get("byte_order") == "big":
        # the JAX reader hands big-endian attribute columns to jnp, which
        # refuses them: its files keep to points, normals and colours here,
        # and the port's reader is held to the arrays it wrote
        extra = {k: attrs.pop(k) for k in ("intensity", "label")}
        tply.save(tmp_path / "x.ply", tcloud.from_numpy(xyz, dict(attrs, **extra),
                                                        device="cpu"), **fmt)
        _, back = tcloud.to_numpy(tply.load(tmp_path / "x.ply", device="cpu"))
        for k, v in extra.items():
            np.testing.assert_array_equal(back[k], v)
            assert back[k].dtype == v.dtype
    faces = np.random.default_rng(1).integers(0, len(xyz), size=(40, 3)).astype(np.int32)
    tc = tcloud.from_numpy(xyz, attrs, capacity=300, device="cpu")
    jc = jcloud.from_numpy(xyz, attrs, capacity=300)
    tply.save(tmp_path / "t.ply", tc, faces=faces, **fmt)
    jply.save(str(tmp_path / "j.ply"), jc, faces=faces, **fmt)
    t_body = (tmp_path / "t.ply").read_bytes()
    j_body = (tmp_path / "j.ply").read_bytes()
    # the same file but for the writer's comment line
    assert t_body.replace(b"pcl_tpu_torch", b"pcl_tpu") == j_body
    for f in ("t.ply", "j.ply"):
        got, gfaces = tply.load_mesh(tmp_path / f, device="cpu")
        want, wfaces = jply.load_mesh(str(tmp_path / f))
        _same_cloud(got, want)
        np.testing.assert_array_equal(gfaces, wfaces)
        np.testing.assert_array_equal(gfaces, faces)
        assert got.capacity == 257 and got.xyz.dtype == torch.float32
    np.testing.assert_array_equal(tcloud.to_numpy(tply.load(tmp_path / "t.ply",
                                                            device="cpu"))[0], xyz)


def test_capacity_and_dispatch(tmp_path):
    xyz, _ = _arrays(2, n=30)
    tio.save(tmp_path / "c.ply", tcloud.make_cloud(xyz, device="cpu"))
    back = tio.load(tmp_path / "c.ply", capacity=64, device="cpu")
    assert back.capacity == 64 and int(back.mask.sum()) == 30
    want = jply.load(str(tmp_path / "c.ply"), capacity=64)
    np.testing.assert_array_equal(back.xyz.numpy(), np.asarray(want.xyz))


def _write(path, text: bytes):
    path.write_bytes(text)
    return path


@pytest.mark.parametrize("body", [
    b"plx\nformat ascii 1.0\nend_header\n",
    b"ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n",
    b"ply\nformat ascii 2.0 x\nelement vertex -1\nend_header\n",
    b"ply\nformat binary_middle_endian 1.0\nelement vertex 0\nend_header\n",
    b"ply\nformat ascii 1.0\nproperty float x\nend_header\n",
    b"ply\nformat ascii 1.0\nbogus line\nend_header\n",
    b"ply\nformat binary_little_endian 1.0\nelement vertex 1000000000\n"
    b"property float x\nproperty float y\nproperty float z\nend_header\n\x00\x00",
    b"ply\nformat ascii 1.0\nelement face 1\nproperty list uchar int vertex_indices\n"
    b"end_header\n3 0 1 2\n",
], ids=["magic", "eof", "negative", "format", "orphan", "unknown", "too_short", "no_vertex"])
def test_malformed_files_rejected_alike(tmp_path, body):
    p = _write(tmp_path / "bad.ply", body)
    with pytest.raises(ValueError) as want:
        jply.load(str(p))
    with pytest.raises(ValueError) as got:
        tply.load(p, device="cpu")
    assert str(got.value) == str(want.value)


def test_list_rows_of_mixed_length(tmp_path):
    """Faces of 3 and 4 vertices come back as a list of arrays, as in the
    JAX reader."""
    text = (b"ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
            b"property float z\nelement face 2\nproperty list uchar int vertex_indices\n"
            b"end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n3 0 1 2\n4 0 1 2 3\n")
    p = _write(tmp_path / "m.ply", text)
    got, gf = tply.load_mesh(p, device="cpu")
    want, wf = jply.load_mesh(str(p))
    _same_cloud(got, want)
    assert [a.tolist() for a in gf] == [a.tolist() for a in wf] == [[0, 1, 2], [0, 1, 2, 3]]


def test_default_device_is_cuda(tmp_path, monkeypatch):
    xyz, _ = _arrays(3, n=5)
    tply.save(tmp_path / "c.ply", tcloud.make_cloud(xyz, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tply.load(tmp_path / "c.ply")
    assert jnp.asarray(xyz).shape == (5, 3)
