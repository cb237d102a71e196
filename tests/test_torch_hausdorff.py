"""Parity of pcl_tpu_torch.core.geometry's ``pairwise_sqdist`` and
``hausdorff`` with the JAX package on the CPU.

``pairwise_sqdist`` keeps the matmul identity (to 1e-6 of ``|a|^2 +
|b|^2``, the products' rounding). ``hausdorff`` takes its directed maxima
from the exact 1-NN (kernel B1's contract, ROADMAP C1) where the JAX package
takes the square root of the clamped matmul identity, so the two agree to
the rounding of that identity: ``2^-22 (|a|^2 + |b|^2)`` in squared
distance, bounded over the cloud."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core import geometry as jg

from pcl_tpu_torch.core import geometry as tg


def test_pairwise_sqdist():
    rng = np.random.default_rng(0)
    a = rng.uniform(-3, 3, size=(200, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, size=(150, 3)).astype(np.float32)
    want = np.asarray(jg.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    got = tg.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    scale = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    assert got.shape == want.shape and (got >= 0).all()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offset", [0.0, 20.0])
def test_hausdorff(masked, offset):
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, size=(900, 3)).astype(np.float32) + np.float32(offset)
    b = (a[:700] + rng.normal(scale=0.02, size=(700, 3))).astype(np.float32)
    b[:5] += 0.5                                        # a few far points
    am, bm = np.ones(len(a), bool), np.ones(len(b), bool)
    if masked:
        am[::3] = False
        bm[:3] = False
        a[~am] = 0.0
        b[~bm] = 0.0
    want = float(jg.hausdorff(*map(jnp.asarray, (a, am, b, bm))))
    got = float(tg.hausdorff(*map(torch.from_numpy, (a, am, b, bm))))
    # the rounding of the identity in the squared distance, taken to the distance
    r2 = 2.0 ** -22 * 2 * float(max((a * a).sum(1).max(), (b * b).sum(1).max()))
    assert abs(got * got - want * want) <= r2
    assert got > 0.3                                     # a far point is valid


def test_hausdorff_no_valid_point():
    a = torch.zeros(4, 3)
    got = tg.hausdorff(a, torch.zeros(4, dtype=torch.bool), a + 1.0, torch.ones(4, dtype=torch.bool))
    want = jg.hausdorff(jnp.zeros((4, 3)), jnp.zeros(4, bool), jnp.ones((4, 3)), jnp.ones(4, bool))
    assert float(got) == float(want)
