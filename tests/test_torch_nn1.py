"""The plain version of the 1-NN kernel (pcl_tpu_torch/ops/nn1.py) against the
Pallas kernel it replaces, run through the Pallas interpreter, and against the
JAX package's CPU path (search/bruteforce.py). The CUDA kernel itself is
compared with the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcl_tpu.ops import pallas_nn
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch.ops import nn1 as tnn1
from pcl_tpu_torch.search import bruteforce as tbf


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
    before = tnn1.nn1.launches
    for got, want in zip(tbf.nn1(*args), tnn1.nn1_plain(*args)):
        assert torch.equal(got, want)
    assert tnn1.nn1.launches == before        # no kernel launch on the CPU


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
