"""Parity of pcl_tpu_torch.ops.segsum with pcl_tpu.ops.pallas_segsum on the CPU.

The JAX kernel runs in the Pallas interpreter; the port's wrapper runs its
plain version on CPU tensors. Both sum each segment in float32, in different
orders (a one-hot matrix product in the JAX kernel, ascending rows in the
port), so a row of a segment of length L may differ by the sum of two
recursive-summation error bounds, 2 (L - 1) u sum|v| with u = 2^-24 (Higham,
Accuracy and Stability, 4.2); ``_tol`` uses that, and never less than
1e-6 sum|v|. Which rows are live and the voxel counts are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.ops import pallas_segsum as jseg

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.ops import segsum

U32 = 2.0 ** -24


def _segments(rng, n, p_new, valid_frac=0.9, tail=2 ** 28):
    steps = (rng.random(n) < p_new).astype(np.int32)
    steps[0] = 0
    seg = np.cumsum(steps).astype(np.int32)
    nvalid = int(n * valid_frac)
    seg[nvalid:] = tail
    return seg, nvalid


def _tol(vals, seg, n):
    """Per-row tolerance [n, 1] from each segment's length and sum|v|."""
    keep = (seg >= 0) & (seg < n)
    mag = np.zeros(n)
    np.add.at(mag, seg[keep], np.abs(vals[keep]).sum(1))
    length = np.bincount(seg[keep], minlength=n)[:n]
    return (np.maximum(1e-6, 2 * np.maximum(length - 1, 0) * U32) * mag)[:, None]


def _np_segsum(vals, seg):
    n = len(seg)
    keep = (seg >= 0) & (seg < n)
    out = np.zeros((n, vals.shape[1]), np.float64)
    np.add.at(out, seg[keep], vals[keep].astype(np.float64))
    return out


@pytest.mark.parametrize("tail", ["n", "2**28"])
@pytest.mark.parametrize("n,p_new", [(1000, 0.3), (4096, 0.05), (700, 0.9)])
def test_segment_sum_sorted_matches_interpreted_kernel(rng, n, p_new, tail):
    seg, nvalid = _segments(rng, n, p_new, tail=n if tail == "n" else 2 ** 28)
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    vals[nvalid:] = 0.0
    want = np.asarray(jseg.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(seg),
                                              chunk=256, interpret=True))
    before = segsum.segment_sum_sorted.launches
    got = segsum.segment_sum_sorted(torch.from_numpy(vals), torch.from_numpy(seg)).numpy()
    assert segsum.segment_sum_sorted.launches == before      # CPU: the plain version
    live = seg[nvalid - 1] + 1          # the JAX kernel leaves rows past these undefined
    tol = _tol(vals, seg, n)
    assert np.all(np.abs(got[:live] - want[:live]) <= tol[:live])
    assert np.all(got[live:] == 0.0)
    assert np.all(np.abs(got - _np_segsum(vals, seg)) <= tol)


@pytest.mark.parametrize("case", ["single_segment", "own_segments"])
def test_segment_sum_sorted_extremes(rng, case):
    n = 600 if case == "single_segment" else 512
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    seg = np.zeros(n, np.int32) if case == "single_segment" else np.arange(n, dtype=np.int32)
    want = np.asarray(jseg.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(seg),
                                              chunk=128, interpret=True))
    got = segsum.segment_sum_sorted(torch.from_numpy(vals), torch.from_numpy(seg)).numpy()
    live = int(seg[-1]) + 1
    assert np.all(np.abs(got[:live] - want[:live]) <= _tol(vals, seg, n)[:live])
    if case == "own_segments":
        np.testing.assert_array_equal(got, vals)      # one row each: exact
    else:
        assert np.all(got[1:] == 0.0)


@pytest.mark.parametrize("w", [1, 7, 131])
def test_segment_sum_sorted_widths(rng, w):
    """Any width: the TPU kernel's W <= 120 lane limit is gone (131 is
    checked against numpy only)."""
    n = 999
    seg, nvalid = _segments(rng, n, 0.4, valid_frac=0.8, tail=n)
    vals = rng.normal(size=(n, w)).astype(np.float32)
    vals[nvalid:] = 0.0
    got = segsum.segment_sum_sorted(torch.from_numpy(vals), torch.from_numpy(seg)).numpy()
    tol = _tol(vals, seg, n)
    assert np.all(np.abs(got - _np_segsum(vals, seg)) <= tol)
    if w <= 120:
        want = np.asarray(jseg.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(seg),
                                                  chunk=128, interpret=True))
        live = seg[nvalid - 1] + 1
        assert np.all(np.abs(got[:live] - want[:live]) <= tol[:live])


def test_segment_sum_sorted_empty_and_all_invalid():
    out = segsum.segment_sum_sorted(torch.zeros((0, 4)), torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 4)
    n = 300
    out = segsum.segment_sum_sorted(torch.zeros((n, 4)), torch.full((n,), n, dtype=torch.int32))
    assert torch.equal(out, torch.zeros((n, 4)))


def _voxel_inputs(rng, n=5000, leaf=0.1):
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.85
    cols = np.concatenate([xyz, rng.normal(size=(n, 2)).astype(np.float32)], 1)
    return xyz, mask, cols, leaf


def test_dense_cell_ids_equal(rng):
    xyz, mask, _, leaf = _voxel_inputs(rng)
    for lf in (leaf, np.float32([0.1, 0.2, 0.05])):
        want = np.asarray(jseg.dense_cell_ids(jnp.asarray(xyz), jnp.asarray(mask), lf))
        got = segsum.dense_cell_ids(torch.from_numpy(xyz), torch.from_numpy(mask), lf)
        np.testing.assert_array_equal(got.numpy(), want)


def test_voxel_sums_matches_interpreted_kernel(rng):
    xyz, mask, cols, leaf = _voxel_inputs(rng)
    lin = jseg.dense_cell_ids(jnp.asarray(xyz), jnp.asarray(mask), leaf)
    want, want_n = jseg.voxel_sums_pallas(jnp.asarray(cols), jnp.asarray(mask), lin,
                                          chunk=256, interpret=True)
    got, got_n = segsum.voxel_sums(torch.from_numpy(cols), torch.from_numpy(mask),
                                   torch.from_numpy(np.array(lin)))
    nv = int(got_n)
    assert nv == int(want_n) and got_n.dtype == torch.int32
    want = np.asarray(want)[:nv]
    got = got.numpy()
    # the weight column counts points: exact
    np.testing.assert_array_equal(got[:nv, -1], want[:, -1])
    assert np.all(got[nv:] == 0.0)
    # sum|v| per voxel: the same sums over |columns|
    mag = segsum.voxel_sums(torch.from_numpy(np.abs(cols)), torch.from_numpy(mask),
                            torch.from_numpy(np.array(lin)))[0].numpy()[:nv, :-1]
    L = want[:, -1:]
    assert np.all(np.abs(got[:nv, :-1] - want[:, :-1])
                  <= np.maximum(1e-6, 2 * np.maximum(L - 1, 0) * U32) * mag)


def test_voxel_centroids_matches_interpreted_kernel(rng):
    xyz, mask, _, leaf = _voxel_inputs(rng)
    want_c, want_m = jseg.voxel_centroids_pallas(
        JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)), leaf, chunk=256,
        interpret=True)
    got_c, got_m = segsum.voxel_centroids(make_cloud(xyz, mask, device="cpu"), leaf)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    m = got_m.numpy()
    # centroids of at most a few points in a 2 m box: float32 rounding
    np.testing.assert_allclose(got_c.numpy()[m], np.asarray(want_c)[m], atol=1e-6)
    assert np.all(got_c.numpy()[~m] == 0.0)


def test_plain_version_sums_in_row_order():
    """The plain version adds a segment's rows in ascending order from 0,
    as the CUDA kernel does: 1e8 + 1 - 1e8 rounds to 0 in float32, not 1."""
    vals = torch.tensor([[1e8], [1.0], [-1e8], [5.0]])
    seg = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    out = segsum.segment_sum_sorted(vals, seg)
    assert out[:, 0].tolist() == [0.0, 5.0, 0.0, 0.0]


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        segsum.segment_sum_sorted(torch.zeros((3, 2), device="meta"),
                                  torch.zeros(3, dtype=torch.int32, device="meta"))
