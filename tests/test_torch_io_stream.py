"""The port's stream side of io/ beside the JAX package's on the same numpy
inputs, made from a seed: the depth buffers, the range coder, octree and
organized compression.

Tolerances: none. Both packages run the same numpy (and pure-Python) code,
so the buffers' frames, the byte streams and the decoded clouds are equal
bit for bit, including a stream that one package writes and the other
reads.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest

from pcl_tpu.core.cloud import from_numpy as jfrom
from pcl_tpu.core.cloud import to_numpy as jto
from pcl_tpu.io import buffers as jbuf
from pcl_tpu.io import compression as jcomp
from pcl_tpu.io import organized_compression as jorg
from pcl_tpu.io import range_coder as jrc

from pcl_tpu_torch.core.cloud import from_numpy, to_numpy
from pcl_tpu_torch.io import buffers as tbuf
from pcl_tpu_torch.io import compression as tcomp
from pcl_tpu_torch.io import organized_compression as torg
from pcl_tpu_torch.io import range_coder as trc


def _frames(rng, dtype, n_frames=12, size=257, drop=0.2):
    """Frames with a share of invalid samples (NaN for floats, 0 for ints)."""
    if np.dtype(dtype).kind == "f":
        f = rng.normal(1.5, 0.4, size=(n_frames, size)).astype(dtype)
        f[rng.random(f.shape) < drop] = np.nan
    else:
        f = rng.integers(1, 3000, size=(n_frames, size)).astype(dtype)
        f[rng.random(f.shape) < drop] = 0
    f[:, :3] = np.nan if np.dtype(dtype).kind == "f" else 0         # all invalid
    return f


@pytest.mark.parametrize("kind", ["SingleBuffer", "MedianBuffer", "AverageBuffer"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.int32])
@pytest.mark.parametrize("window", [1, 4, 5])
def test_buffers_match_jax(kind, dtype, window):
    rng = np.random.default_rng(3)
    frames = _frames(rng, dtype)
    size = frames.shape[1]
    args = (size,) if kind == "SingleBuffer" else (size, window)
    a, b = getattr(tbuf, kind)(*args, dtype=dtype), getattr(jbuf, kind)(*args, dtype=dtype)
    np.testing.assert_array_equal(a.data, b.data)
    for fr in frames:
        a.push(fr)
        b.push(fr)
        assert a.data.dtype == b.data.dtype and a.size == b.size
        np.testing.assert_array_equal(a.data, b.data)
        assert (a[5] == b[5]) or (np.isnan(a[5]) and np.isnan(b[5]))


def test_median_and_average_against_numpy():
    """The port's buffers against a plain numpy per-pixel window statistic:
    the upper median and the mean of the valid samples."""
    rng = np.random.default_rng(4)
    frames = _frames(rng, np.float32, n_frames=9, size=400)
    med, avg = tbuf.MedianBuffer(400, 5), tbuf.AverageBuffer(400, 5)
    for k, fr in enumerate(frames):
        med.push(fr)
        avg.push(fr)
        win = frames[max(0, k - 4):k + 1].astype(np.float64)
        srt = np.sort(win, axis=0)                      # NaN sort last
        n = np.sum(~np.isnan(win), axis=0)
        upper = np.take_along_axis(srt, np.minimum(n // 2, len(win) - 1)[None], 0)[0]
        np.testing.assert_array_equal(med.data, np.where(n > 0, upper, np.nan).astype(np.float32))
        with np.errstate(invalid="ignore"):
            mean = np.nansum(win, axis=0) / np.maximum(n, 1)
        np.testing.assert_array_equal(avg.data, np.where(n > 0, mean, np.nan).astype(np.float32))


@pytest.mark.parametrize("source", ["uniform", "skewed", "bitmasks", "empty", "one"])
def test_range_coder_streams_match_jax(source):
    rng = np.random.default_rng(5)
    data = {
        "uniform": rng.integers(0, 256, 3000).astype(np.uint8).tobytes(),
        "skewed": rng.geometric(0.3, 6000).clip(0, 255).astype(np.uint8).tobytes(),
        "bitmasks": None,
        "empty": b"",
        "one": b"\x07",
    }[source]
    if data is None:
        xyz = rng.normal(size=(4000, 3)).astype(np.float32)
        cells = np.floor((xyz - xyz.min(0)) / 0.05).astype(np.uint64)
        keys = np.unique(tcomp._morton_np(cells, 8))
        data = tcomp._encode_bitmasks(keys, 8)
    enc = trc.encode(data)
    assert enc == jrc.encode(data)
    assert trc.decode(enc, len(data)) == data
    assert jrc.decode(enc, len(data)) == data


def _scene(rng, n=6000):
    a = rng.uniform(-3.0, 3.0, size=(n, 3))
    a[: n // 2, 2] = 0.1 * np.sin(a[: n // 2, 0])           # a wavy floor
    return a.astype(np.float32)


@pytest.mark.parametrize("resolution,depth", [(0.05, None), (0.2, 7), (0.01, None)])
def test_octree_compression_matches_jax(resolution, depth):
    rng = np.random.default_rng(6)
    xyz = _scene(rng)
    t_blob = tcomp.compress_cloud(from_numpy(xyz, device="cpu"), resolution, depth)
    j_blob = jcomp.compress_cloud(jfrom(xyz), resolution, depth)
    assert t_blob == j_blob
    t_back, _ = to_numpy(tcomp.decompress_cloud(j_blob, device="cpu"))
    j_back, _ = jto(jcomp.decompress_cloud(t_blob))
    np.testing.assert_array_equal(t_back, j_back)
    # the decoded centres are the occupied voxels' centres, computed apart
    # (the header holds the resolution as float32)
    origin = xyz.min(0)
    cells = np.unique(np.floor((xyz - origin) / resolution).astype(np.int64), axis=0)
    res32 = float(np.float32(resolution))
    centres = ((cells + 0.5) * res32 + origin.astype(np.float64)).astype(np.float32)
    key = lambda p: np.lexsort(p.T[::-1])  # noqa: E731
    np.testing.assert_array_equal(t_back[key(t_back)], centres[key(centres)])


def test_octree_compression_capacity_and_errors():
    rng = np.random.default_rng(7)
    xyz = _scene(rng, 500)
    blob = tcomp.compress_cloud(from_numpy(xyz, device="cpu"), 0.1)
    c = tcomp.decompress_cloud(blob, capacity=4096, device="cpu")
    assert c.capacity == 4096
    with pytest.raises(ValueError, match="depth too small"):
        tcomp.compress_cloud(from_numpy(xyz, device="cpu"), 0.001, depth=3)
    with pytest.raises(ValueError, match="not a pcl_tpu compressed cloud"):
        tcomp.decompress_cloud(b"nope" + blob, device="cpu")


@pytest.mark.parametrize("with_rgb", [False, True])
def test_organized_compression_matches_jax(with_rgb):
    rng = np.random.default_rng(8)
    H, W, f = 48, 64, 60.0
    z = rng.uniform(0.5, 4.0, size=(H, W)).astype(np.float32)
    valid = rng.random((H, W)) > 0.1
    u = np.arange(W, dtype=np.float32) - W / 2.0
    v = np.arange(H, dtype=np.float32) - H / 2.0
    xyz = np.stack([u[None] * z / f, v[:, None] * z / f, z], -1).astype(np.float32)
    rgb = rng.random((H, W, 3)).astype(np.float32) if with_rgb else None
    t_blob = torg.encode_organized(xyz, valid, rgb, focal=f)
    assert t_blob == jorg.encode_organized(xyz, valid, rgb, focal=f)
    t_out, j_out = torg.decode_organized(t_blob), jorg.decode_organized(t_blob)
    for a, b in zip(t_out, j_out):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    back, ok, _ = t_out
    np.testing.assert_array_equal(ok, valid & (np.clip(z * 1000.0, 0, 65535).astype(np.uint16) > 0))
    d16 = np.clip(np.where(valid, z, 0) * 1000.0, 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(back[..., 2], d16.astype(np.float32) / 1000.0)
