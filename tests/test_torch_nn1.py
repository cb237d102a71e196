"""The plain version of the 1-NN kernel (pcl_tpu_torch/ops/nn1.py) against the
Pallas kernel it replaces, run through the Pallas interpreter, and against the
JAX package's CPU path (search/bruteforce.py). The CUDA kernel itself is
compared with the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcl_tpu.ops import pallas_nn
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch.ops import nn1 as tnn1
from pcl_tpu_torch.search import bruteforce as tbf
from pcl_tpu_torch.utils import trace


def _case(rng, kind):
    """(target, tmask, queries) for one of the contract's cases."""
    if kind == "ragged":
        t = rng.uniform(-5, 5, size=(333, 3))
        q = rng.uniform(-5, 5, size=(201, 3))
        m = np.ones(333, bool)
    elif kind == "masked":
        t = rng.uniform(-5, 5, size=(600, 3))
        q = rng.uniform(-5, 5, size=(130, 3))
        m = rng.uniform(size=600) > 0.4
    elif kind == "none_valid":
        t = rng.uniform(-5, 5, size=(300, 3))
        q = rng.uniform(-5, 5, size=(50, 3))
        m = np.zeros(300, bool)
    elif kind == "one_valid":
        t = rng.uniform(-5, 5, size=(300, 3))
        q = rng.uniform(-5, 5, size=(50, 3))
        m = np.zeros(300, bool)
        m[277] = True
    elif kind == "ties":
        # every point twice, and in a second target tile: exact score ties,
        # which the lowest index must win; queries sit on target points
        base = rng.uniform(-5, 5, size=(150, 3))
        t = np.concatenate([base, base[::-1], base])
        q = np.concatenate([base[rng.integers(0, 150, 60)],
                            rng.uniform(-5, 5, size=(40, 3))])
        m = np.ones(450, bool)
        m[:20] = False                 # some first copies masked out
    else:
        raise ValueError(kind)
    return t.astype(np.float32), m, q.astype(np.float32)


KINDS = ["ragged", "masked", "none_valid", "one_valid", "ties"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_interpret(rng, kind):
    t, m, q = _case(rng, kind)
    i_p, d_p = pallas_nn.nn1_pallas(jnp.asarray(t), jnp.asarray(m), jnp.asarray(q),
                                    qt=128, tt=256, interpret=True)
    i_t, d_t = tnn1.nn1_plain(torch.from_numpy(t), torch.from_numpy(m), torch.from_numpy(q))
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    # the same contract: indices exactly (lowest index on ties, 0 when none
    # is valid), the exact squared distance to 1e-6 relative, +inf alike
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_on_cpu_is_plain(rng, kind):
    t, m, q = _case(rng, kind)
    args = (torch.from_numpy(t), torch.from_numpy(m), torch.from_numpy(q))
    before = trace.counts().get("ops.nn1.launches", 0)
    for got, want in zip(tbf.nn1(*args), tnn1.nn1_plain(*args)):
        assert torch.equal(got, want)
    assert trace.counts().get("ops.nn1.launches", 0) == before   # no kernel launch on the CPU


@pytest.mark.parametrize("kind", ["ragged", "masked", "one_valid"])
def test_plain_matches_xla_bruteforce(rng, kind):
    """The JAX CPU path returns the matmul-identity distance q^2+t^2-2q.t
    (clamped at 0), the port the exact one: their difference is float32
    cancellation, bounded by a few ulps of ||q||^2 + ||t||^2."""
    t, m, q = _case(rng, kind)
    i_b, d_b = (np.asarray(a) for a in jbf.nn1(jnp.asarray(t), jnp.asarray(m), jnp.asarray(q)))
    i_t, d_t = (a.numpy() for a in tnn1.nn1_plain(torch.from_numpy(t), torch.from_numpy(m),
                                                    torch.from_numpy(q)))
    scale = np.sum(q * q, axis=1) + np.sum(t[i_t] ** 2, axis=1)
    assert np.all(np.abs(d_t - d_b) <= 4e-7 * scale)
    # away from near-ties the winners are the same
    assert np.mean(i_t == i_b) > 0.99


def test_plain_any_dimension_and_chunks(rng, monkeypatch):
    """The plain version takes any D (the kernel is 3-D only) and gives the
    same answer whatever its chunk size."""
    t = rng.normal(size=(257, 6)).astype(np.float32)
    q = rng.normal(size=(65, 6)).astype(np.float32)
    m = rng.uniform(size=257) > 0.1
    args = (torch.from_numpy(t), torch.from_numpy(m), torch.from_numpy(q))
    i1, d1 = tnn1.nn1_plain(*args)
    monkeypatch.setattr(tnn1, "_CHUNK_ELEMS", 1000)
    i2, d2 = tnn1.nn1_plain(*args)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    dist = ((q[:, None, :] - t[None]) ** 2).sum(-1)
    dist[:, ~m] = np.inf
    np.testing.assert_array_equal(i1.numpy(), dist.argmin(1))
    np.testing.assert_allclose(d1.numpy(), dist.min(1), rtol=1e-5)


def test_wrapper_rejects_other_devices():
    t = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tnn1.nn1(t, torch.ones(4, dtype=torch.bool, device="meta"), t)
    with pytest.raises(ValueError, match="different devices"):
        tnn1.nn1(t, torch.ones(4, dtype=torch.bool), torch.zeros((2, 3)))


def _tie_case(rng, edges, m):
    """Targets in which the point at ``b - 1`` is repeated at ``b`` for every
    ``b`` of ``edges`` (and target 5 again at ``m - 7``), and queries that
    sit on those points: exact ties either side of a boundary."""
    t = rng.uniform(-5, 5, size=(m, 3)).astype(np.float32)
    for b in edges:
        t[b] = t[b - 1]
    t[m - 7] = t[5]
    q = np.concatenate([t[edges], t[[5]],
                        rng.uniform(-5, 5, size=(20, 3)).astype(np.float32)])
    return t, np.ones(m, bool), q


@pytest.mark.parametrize("edges,m", [([32, 64], 300), ([128, 256], 520), ([32, 128, 2048], 2100)])
def test_plain_ties_across_boundaries_match_pallas_interpret(rng, edges, m):
    """The lowest index wins a tie whose copies straddle the CUDA kernel's
    sub-tile (32), the TPU kernel's target tile (128 here) and the CUDA
    kernel's shared-memory tile (2048): plain against the interpreted TPU
    kernel, indices exactly, distances to 1e-6 relative."""
    t, tm, q = _tie_case(rng, edges, m)
    i_p, d_p = pallas_nn.nn1_pallas(jnp.asarray(t), jnp.asarray(tm), jnp.asarray(q),
                                    qt=128, tt=128, interpret=True)
    i_t, d_t = tnn1.nn1_plain(torch.from_numpy(t), torch.from_numpy(tm), torch.from_numpy(q))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), rtol=1e-6, atol=0)
    # the tied queries found the lower copy, at distance 0
    np.testing.assert_array_equal(i_t.numpy()[:len(edges)], np.asarray(edges) - 1)
    assert i_t[len(edges)] == 5 and np.all(d_t.numpy()[:len(edges) + 1] == 0.0)


def test_plain_point_at_the_origin_matches_pallas_interpret(rng):
    """A query on a target at the origin, three times in the target with
    both signs of zero: the scores +0.0 and -0.0 tie and index 3 wins."""
    t = rng.uniform(-5, 5, size=(300, 3)).astype(np.float32)
    t[[3, 70, 257]] = 0.0
    t[70] = -0.0
    q = np.concatenate([np.zeros((2, 3), np.float32),
                        rng.uniform(-5, 5, size=(30, 3)).astype(np.float32)])
    q[1] = -0.0
    tm = np.ones(300, bool)
    i_p, d_p = pallas_nn.nn1_pallas(jnp.asarray(t), jnp.asarray(tm), jnp.asarray(q),
                                    qt=128, tt=128, interpret=True)
    i_t, d_t = tnn1.nn1_plain(torch.from_numpy(t), torch.from_numpy(tm), torch.from_numpy(q))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), rtol=1e-6, atol=0)
    assert i_t[:2].tolist() == [3, 3] and d_t[:2].tolist() == [0.0, 0.0]


# the H100 holds 792 blocks of the search kernel at once (132 SMs x 6)
PLAN_TABLE = [(1, 1), (1, 17), (1, 120_000), (300, 700), (2048, 2048), (2048, 120_000),
              (120_000, 2048), (120_000, 120_000), (1_000_000, 1_000_000), (5000, 31),
              (1025, 2082)]


@pytest.mark.parametrize("slots", [132, 792])
@pytest.mark.parametrize("nq,m", PLAN_TABLE)
def test_plan_covers_the_targets(nq, m, slots):
    """What Python decides for the kernel: the slices cover the targets with
    none to spare, in whole sub-tiles, within the limits, and the scratch
    tensor holds the packed targets and one (minimum, index) pair per slice
    and query."""
    slices, slice_len = tnn1.nn1_plan(nq, m, slots)
    assert 1 <= slices <= tnn1.MAX_SLICES
    assert slice_len % tnn1.SUB_TILE == 0
    assert slices * slice_len >= m > (slices - 1) * slice_len
    assert slices == 1 or slice_len >= tnn1.MIN_SLICE
    assert tnn1.scratch_elems(nq, m, slices) == 4 * m + 2 * slices * nq


def test_plan_fills_the_card():
    """Few queries against many targets are cut into enough slices to give
    every block slot of the card work (the first design ran 8 blocks here);
    a sweep that fills the card many times over is cut so that its last wave
    is nearly full; and the plan never splits more than it must."""
    slots = 792
    tile = lambda nq: -(-nq // tnn1.QUERY_BLOCK)
    for nq, least in ((1, 132), (2048, 0.5 * slots)):     # a block per SM; half the slots
        slices, _ = tnn1.nn1_plan(nq, 120_000, slots)
        assert least <= tile(nq) * slices <= slots
    slices, _ = tnn1.nn1_plan(120_000, 120_000, slots)
    blocks = tile(120_000) * slices
    assert blocks / (-(-blocks // slots) * slots) >= 0.95 and slices <= 32
    # Q alone fills the card evenly: one slice
    assert tnn1.nn1_plan(slots * tnn1.QUERY_BLOCK, 50_000, slots)[0] == 1
    # nothing to search
    assert tnn1.nn1_plan(5, 0, slots) == (0, 0) and tnn1.nn1_plan(0, 5, slots) == (0, 0)


def test_wrapper_takes_slices_on_cpu(rng):
    """``slices`` only steers the kernel: on CPU tensors the plain version
    answers whatever it is."""
    t, m, q = _case(rng, "ties")
    args = (torch.from_numpy(t), torch.from_numpy(m), torch.from_numpy(q))
    for got, want in zip(tnn1.nn1(*args, slices=3), tnn1.nn1_plain(*args)):
        assert torch.equal(got, want)
