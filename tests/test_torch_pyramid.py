"""Parity of pcl_tpu_torch.registration.pyramid with the JAX package on the
CPU: the slot hash bit for bit (negative and large bins, and more than 16
dimensions, where the extra multipliers wrap in uint32), the tables
exactly (sums of 0/1 weights), the similarity to 1e-6."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.registration import pyramid as jp

from pcl_tpu_torch.registration import pyramid as tp


@pytest.mark.parametrize("d", [3, 16, 33])
@pytest.mark.parametrize("table_size", [4096, 1000])
def test_hash_bins_bit_exact(d, table_size):
    rng = np.random.default_rng(d)
    bins = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(300, d)).astype(np.int32)
    bins[:20] = rng.integers(-5, 64, size=(20, d))
    np.testing.assert_array_equal(tp._hash_bins(torch.from_numpy(bins), table_size).numpy(),
                                  np.asarray(jp._hash_bins(jnp.asarray(bins), table_size)))


def _features(seed, d=33, n=400, scale=1.0):
    f = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32) * scale
    return f, np.stack([np.full(d, -5.0), np.full(d, 5.0)], 1).astype(np.float32)


def test_build_and_compare_match_jax():
    f1, ranges = _features(0, scale=2.0)
    f2 = (f1 + np.random.default_rng(1).normal(scale=0.05, size=f1.shape)).astype(np.float32)
    f3, _ = _features(2, scale=3.0)
    m = np.ones(len(f1), bool)
    m[::7] = False
    pj = [jp.build_pyramid(jnp.asarray(f), jnp.asarray(m), jnp.asarray(ranges))
          for f in (f1, f2, f3)]
    pt = [tp.build_pyramid(torch.from_numpy(f), torch.from_numpy(m), torch.from_numpy(ranges))
          for f in (f1, f2, f3)]
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(b.tables.numpy(), np.asarray(a.tables))
        assert float(b.n_features) == float(a.n_features)
        assert (b.n_levels, b.n_dims) == (a.n_levels, a.n_dims)
    for i, k in ((0, 0), (0, 1), (0, 2), (1, 2)):
        want = float(jp.compare_pyramids(pj[i], pj[k]))
        assert float(tp.compare_pyramids(pt[i], pt[k])) == pytest.approx(want, abs=1e-6)
    assert float(tp.compare_pyramids(pt[0], pt[0])) == pytest.approx(1.0, abs=1e-6)
    assert float(tp.compare_pyramids(pt[0], pt[1])) > float(tp.compare_pyramids(pt[0], pt[2]))
