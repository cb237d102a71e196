"""Parity of pcl_tpu_torch's cell list with pcl_tpu/search/cell_list.py on the
CPU: the bucket hash bit for bit, the packed table and populations exactly,
and nn1_radius on tables built by the port and on tables carried over from
the JAX package through pcl_tpu_torch.interop."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcl_tpu.search import cell_list as jcl

from pcl_tpu_torch import interop
from pcl_tpu_torch.search import cell_list as tcl


@pytest.mark.parametrize("table_size", [1 << 17, 1000003, 97])
def test_hash_bit_exact(rng, table_size):
    edge = np.array([[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 7],
                     [-2 ** 31, 2 ** 31 - 1, -123456789]], np.int32)
    coords = np.concatenate([
        edge,
        rng.integers(-2 ** 31, 2 ** 31 - 1, size=(2000, 3)),
        rng.integers(-40, 40, size=(2000, 3)),
    ]).astype(np.int32)
    want = np.asarray(jcl._hash(jnp.asarray(coords), table_size))
    got = tcl._hash(torch.from_numpy(coords), table_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _cloud(rng, n=900):
    """Uniform points with a dense cluster (overflows small buckets) and
    some masked points."""
    xyz = np.concatenate([rng.uniform(-4, 4, size=(n - 100, 3)),
                          rng.uniform(0.1, 0.3, size=(100, 3))]).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    return xyz, mask


BUILDS = [
    dict(cell_size=1.0, table_size=512, cap=8),                 # hash, overflow
    dict(cell_size=0.7, table_size=1 << 12, cap=64),            # hash, roomy
    dict(cell_size=1.0, cap=8, dims=(10, 10, 10)),              # dense, overflow
    dict(cell_size=0.5, cap=32, dims=(20, 18, 17)),             # dense, ragged dims
    dict(cell_size=1.0, cap=8, dims=(4, 4, 4)),                 # dense, points out of grid
]


def _build_both(rng, spec):
    xyz, mask = _cloud(rng)
    kw = dict(spec)
    cell = kw.pop("cell_size")
    j = jcl.build(jnp.asarray(xyz), jnp.asarray(mask), jnp.float32(cell), **kw)
    t = tcl.build(torch.from_numpy(xyz), torch.from_numpy(mask), np.float32(cell), **kw)
    return xyz, mask, j, t


@pytest.mark.parametrize("spec", BUILDS)
def test_build_equal(rng, spec):
    _, _, j, t = _build_both(rng, spec)
    assert t.table_size == j.table_size and t.cap == j.cap and t.dims == j.dims
    # the packed rows (coordinates, 1e30 empties, sign-encoded overflow
    # indices) and the true populations are equal, bit for bit
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    if j.origin is not None:
        np.testing.assert_array_equal(t.origin.numpy(), np.asarray(j.origin))
    if spec["cap"] == 8:
        assert (t.data.numpy()[:, 3::4] < 0).any()      # overflow was encoded


def _queries(rng, xyz):
    near = xyz[rng.integers(0, len(xyz), 300)] + rng.normal(scale=0.2, size=(300, 3))
    far = rng.uniform(-30, 30, size=(60, 3))             # out of every grid
    return np.concatenate([near, far]).astype(np.float32)


def _same_nn1_radius(jt, tt, q, r, compact):
    want = [np.asarray(a) for a in jcl.nn1_radius(jt, jnp.asarray(q), r,
                                                   compact=compact, with_dst=True)]
    got = [a.numpy() for a in tcl.nn1_radius(tt, torch.from_numpy(q), r,
                                              compact=compact, with_dst=True)]
    (wi, wd, wtr, wdst), (gi, gd, gtr, gdst) = want, got
    np.testing.assert_array_equal(gtr, wtr)
    hit = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), hit)
    assert hit.any() and not hit.all()
    # winners: same index and coordinates; distances of the same float32
    # terms summed in the same order, to 1e-6 relative
    np.testing.assert_array_equal(gi[hit], wi[hit])
    np.testing.assert_array_equal(gdst[hit], wdst[hit])
    np.testing.assert_allclose(gd[hit], wd[hit], rtol=1e-6)
    # without with_dst the same triple comes back
    idx, d2, tr = tcl.nn1_radius(tt, torch.from_numpy(q), r, compact=compact)
    assert np.array_equal(idx.numpy()[hit], gi[hit]) and np.array_equal(tr.numpy(), gtr)
    return gtr


@pytest.mark.parametrize("spec", BUILDS)
@pytest.mark.parametrize("compact", [True, False])
def test_nn1_radius_on_port_table(rng, spec, compact):
    xyz, mask, j, t = _build_both(rng, spec)
    q = _queries(rng, xyz)
    # compact (8 cells) needs cell >= 2r; the 27-cell scheme cell >= r
    r = spec["cell_size"] / (2.0 if compact else 1.0)
    trunc = _same_nn1_radius(j, t, q, r, compact)
    if spec["cap"] == 8 and spec.get("dims") != (4, 4, 4):
        assert trunc.any()


@pytest.mark.parametrize("spec", [BUILDS[0], BUILDS[2]])
def test_nn1_radius_on_carried_table(rng, spec):
    """A table the JAX package built, carried over by interop, answers the
    same as it does there."""
    xyz, _, j, _ = _build_both(rng, spec)
    carried = interop.cell_table_from_arrays(
        np.asarray(j.cell_size), j.table_size, j.cap, np.asarray(j.data),
        np.asarray(j.count), j.dims, None if j.origin is None else np.asarray(j.origin),
        device="cpu")
    q = _queries(rng, xyz)
    for compact, r in ((True, spec["cell_size"] / 2), (False, spec["cell_size"])):
        _same_nn1_radius(j, carried, q, r, compact)


def test_nn1_radius_chunks_agree(rng, monkeypatch):
    """Chunking the queries to bound memory changes nothing."""
    xyz, _, _, t = _build_both(rng, BUILDS[2])
    q = torch.from_numpy(_queries(rng, xyz))
    whole = tcl.nn1_radius(t, q, 0.5, compact=True, with_dst=True)
    monkeypatch.setattr(tcl, "_CHUNK_SLOTS", 8 * t.cap * 7)     # 7 queries a chunk
    for a, b in zip(whole, tcl.nn1_radius(t, q, 0.5, compact=True, with_dst=True)):
        assert torch.equal(a, b)
    assert len(tcl.nn1_radius(t, q[:0], 0.5, compact=True)[0]) == 0


def test_interop_rejects_mismatched_table():
    with pytest.raises(ValueError):
        interop.cell_table_from_arrays(1.0, 10, 4, np.zeros((11, 12), np.float32),
                                       np.zeros(11, np.int32), device="cpu")
