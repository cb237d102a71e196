"""Parity of pcl_tpu_torch.search.hashgrid with pcl_tpu.search.hashgrid on the
CPU: the CSR build, kNN and radius search, with hash collisions between the
27 offsets (a small table), overflowing buckets (a small bucket cap) and
exact duplicate points (ties).

Tolerance: both sides sum the same three squared differences in the same
order, so distances agree to 1e-6 relative (measured: bitwise); indices,
``valid``, ``count`` and ``truncated`` are compared exactly. On a tie both
take the earlier candidate slot (``lax.top_k``; the port's one stable sort).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.search import hashgrid as jhg

from pcl_tpu_torch.search import hashgrid as thg


def _cloud(seed, n=900, dup=True):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    if dup:
        xyz[n // 2: n // 2 + 60] = xyz[:60]        # exact ties
    mask = rng.random(n) < 0.9
    xyz[~mask] = 0.0
    q = np.concatenate([xyz[:40], rng.uniform(-1.2, 1.2, size=(160, 3)).astype(np.float32)])
    return xyz, mask, q


def _grids(xyz, mask, cell, table_size):
    j = jhg.build(jnp.asarray(xyz), jnp.asarray(mask), cell, table_size=table_size)
    t = thg.build(torch.from_numpy(xyz), torch.from_numpy(mask), cell, table_size=table_size)
    return j, t


@pytest.mark.parametrize("table_size", [1 << 16, 64])
def test_build_matches_jax(table_size):
    xyz, mask, _ = _cloud(0)
    j, t = _grids(xyz, mask, 0.25, table_size)
    assert t.table_size == j.table_size
    np.testing.assert_array_equal(t.sorted_idx.numpy(), np.asarray(j.sorted_idx))
    np.testing.assert_array_equal(t.bucket_start.numpy(), np.asarray(j.bucket_start))
    np.testing.assert_array_equal(t.sorted_mask.numpy(), np.asarray(j.sorted_mask))
    np.testing.assert_array_equal(t.sorted_xyz.numpy(), np.asarray(j.sorted_xyz))


def _same(got, want):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[2], want[2])                    # valid
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)            # sqdist (inf equal)
    np.testing.assert_array_equal(got[0][got[2]], want[0][want[2]])   # indices
    for g, w in zip(got[3:], want[3:]):                               # count, truncated
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("table_size,bucket_cap,k", [
    (1 << 16, 32, 8),      # roomy: nothing truncated
    (64, 32, 8),           # 64 buckets: offsets collide, duplicates masked
    (1 << 16, 4, 8),       # overflowing buckets: truncated
    (1 << 16, 2, 40),      # k past the valid candidates: +inf rows
])
def test_knn_matches_jax(table_size, bucket_cap, k):
    xyz, mask, q = _cloud(1)
    j, t = _grids(xyz, mask, 0.25, table_size)
    want = jhg.knn(j, jnp.asarray(q), k, bucket_cap=bucket_cap)
    got = thg.knn(t, torch.from_numpy(q), k, bucket_cap=bucket_cap)
    assert got[0].dtype == torch.int32 and got[0].shape == (len(q), k)
    _same(got, want)
    if bucket_cap == 4:
        assert got[3].any() and not got[3].all()


@pytest.mark.parametrize("table_size,bucket_cap", [(1 << 16, 32), (64, 16), (1 << 16, 3)])
def test_radius_matches_jax(table_size, bucket_cap):
    xyz, mask, q = _cloud(2)
    j, t = _grids(xyz, mask, 0.2, table_size)
    want = jhg.radius(j, jnp.asarray(q), 0.2, 12, bucket_cap=bucket_cap)
    got = thg.radius(t, torch.from_numpy(q), 0.2, 12, bucket_cap=bucket_cap)
    _same(got, want)


def test_knn_exact_within_the_cell():
    """Where nothing is truncated and the k-th neighbour lies within one cell,
    the hash grid's lists are the brute-force lists."""
    from pcl_tpu_torch.search import bruteforce

    xyz, mask, _ = _cloud(3, n=3000, dup=False)
    q = np.random.default_rng(4).uniform(-0.9, 0.9, size=(300, 3)).astype(np.float32)
    t = thg.build(torch.from_numpy(xyz), torch.from_numpy(mask), 0.3)
    idx, d2, valid, trunc = thg.knn(t, torch.from_numpy(q), 6, bucket_cap=64)
    bi, bd, bv = bruteforce.knn(torch.from_numpy(xyz), torch.from_numpy(mask),
                                torch.from_numpy(q), 6)
    inside = (~trunc) & (bd[:, -1] < 0.3 ** 2)
    assert inside.sum() > 0.9 * len(q)
    np.testing.assert_array_equal(idx[inside].numpy(), bi[inside].numpy())
    np.testing.assert_allclose(d2[inside].numpy(), bd[inside].numpy(), atol=1e-6)


def test_grid_carried_from_jax():
    """A JAX-built grid, carried across by ``interop.hashgrid_from_arrays``,
    answers as the JAX package does."""
    from pcl_tpu_torch import interop

    xyz, mask, q = _cloud(5)
    j = jhg.build(jnp.asarray(xyz), jnp.asarray(mask), 0.25, table_size=128)
    t = interop.hashgrid_from_arrays(
        np.asarray(j.cell_size), j.table_size, np.asarray(j.sorted_xyz),
        np.asarray(j.sorted_idx), np.asarray(j.sorted_mask), np.asarray(j.bucket_start),
        device="cpu")
    _same(thg.knn(t, torch.from_numpy(q), 5), jhg.knn(j, jnp.asarray(q), 5))
    with pytest.raises(ValueError, match="does not match"):
        interop.hashgrid_from_arrays(0.25, 64, np.asarray(j.sorted_xyz), np.asarray(j.sorted_idx),
                                     np.asarray(j.sorted_mask), np.asarray(j.bucket_start),
                                     device="cpu")
