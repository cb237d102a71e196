"""Parity of pcl_tpu_torch.keypoints.iss with the JAX package on the CPU,
with both weightings, on the six faces of a noisy box.

The neighbourhoods and scatter matrices agree bit for bit (the brute radius
search's distances are the JAX package's, ROADMAP F2); the eigenvalues come
from ``eigh33``'s closed form, whose ``arccos`` loses accuracy where two
eigenvalues meet (C9: up to 2.3e-4 of a neighbourhood's largest eigenvalue
on thin edges, whose two small eigenvalues nearly coincide; on such edges
half the points have a decision within that of its threshold). So saliencies
are compared to 1e-3 of each point's largest eigenvalue, and the keypoint
masks wherever no decision lies within that of its threshold: the two ratio
tests, ``l3 > 0``, and the non-max test against every neighbour's
saliency."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest

from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.keypoints.iss import iss3d_keypoints as jiss
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.keypoints import iss3d_keypoints as tiss


def _box(seed=3, n=250):
    """The six faces of a 2 x 1.4 x 0.9 box, ``n`` points each, 1 cm noise."""
    rng = np.random.default_rng(seed)
    faces = []
    for axis in range(3):
        for side in (-1, 1):
            p = rng.uniform(-1, 1, size=(n, 3))
            p[:, axis] = side
            faces.append(p * np.float32([1.0, 0.7, 0.45]))
    return (np.concatenate(faces) + rng.normal(scale=0.01, size=(6 * n, 3))).astype(np.float32)


def _margins(xyz, r, nr, gamma, dw, tol):
    """Points whose every decision, on the JAX side, is further than ``tol``
    of their largest eigenvalue from its threshold (float64 eigenvalues of the
    same scatter matrices), and each point's tolerance."""
    x, m = jnp.asarray(xyz), jnp.ones(len(xyz), bool)
    idx, _, valid, count = jbf.radius(x, m, x, r, cap=64)
    idx = np.asarray(idx)
    valid = np.asarray(valid)
    count = np.asarray(count)
    if dw:
        w = (1.0 / np.maximum(count, 1))[idx] * valid
        w = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
    else:
        w = valid.astype(np.float64)
    d = xyz[idx] - xyz[:, None, :]
    cov = np.einsum("nk,nki,nkj->nij", w, d, d)
    lam = np.linalg.eigvalsh(cov)                      # float64, ascending
    l3, l2, l1 = lam[:, 0], lam[:, 1], lam[:, 2]
    e = tol * l1
    firm = (np.abs(l2 - gamma * l1) > e) & (np.abs(l3 - gamma * l2) > e) & (np.abs(l3) > e)
    cand = (l2 < gamma * l1) & (l3 < gamma * l2) & (l3 > 0) & (count >= 5)
    sal = np.where(cand, l3, -np.inf)
    nidx, _, nvalid, _ = (np.asarray(v) for v in jbf.radius(x, m, x, nr, cap=64))
    # the non-max test: every other neighbour is firmly no candidate, or a
    # firm candidate whose saliency lies further from this one than both
    # errors; a firm non-candidate is no keypoint whatever its neighbours
    other = nvalid & (nidx != np.arange(len(xyz))[:, None])
    with np.errstate(invalid="ignore"):
        apart = np.abs(sal[nidx] - sal[:, None]) > e[nidx] + e[:, None]
    settled = firm[nidx] & (~cand[nidx] | apart)
    return firm & (~cand | np.all(settled | ~other, axis=1)), e


@pytest.mark.parametrize("density_weights", [False, True])
def test_iss_matches_jax(density_weights):
    xyz = _box()
    jm, js = (np.asarray(v) for v in jiss(JCloud(xyz=jnp.asarray(xyz), mask=jnp.ones(len(xyz), bool)),
                                          0.3, 0.15, density_weights=density_weights))
    tm, ts = (v.numpy() for v in tiss(make_cloud(xyz, device="cpu"), 0.3, 0.15,
                                      density_weights=density_weights))
    firm, tol = _margins(xyz, 0.3, 0.15, 0.975, density_weights, 1e-3)
    assert firm.sum() >= 0.3 * len(xyz) and jm[firm].sum() >= 8
    assert np.all(np.abs(ts - js)[firm] <= tol[firm])
    np.testing.assert_array_equal(tm[firm], jm[firm])
    assert tm.sum() >= 8 and jm.sum() >= 8


def test_iss_masked_rows_are_never_keypoints():
    xyz = _box()
    c = make_cloud(xyz, mask=np.arange(len(xyz)) % 5 != 0, device="cpu")
    kp, sal = tiss(c, 0.3, 0.15)
    assert not kp[~c.mask].any() and (sal[~c.mask] == 0).all()
