"""Parity of pcl_tpu_torch.features.fpfh with pcl_tpu.features.fpfh on the CPU.

Tolerances. Pair features f1-f4 agree to 1e-5 (float32 dot products, cross
products and atan2 in another order). A bin index is ``floor(nbins (f - lo) /
(hi - lo))``, so an ulp of f flips a bin when f lies on an edge: bins are
compared exactly where f is more than 1e-5 from every edge, and histograms
to 1e-4 (of blocks summing to 100) on points none of whose pairs has such an
f (for FPFH: nor any neighbour's pairs; ROADMAP C19). Two more decisions
turn on a rounding: which point of a pair is the source (``|angle1|`` against
``|angle2|``) and the side of atan2's cut at +-pi; pairs within 1e-5 of
either count as on an edge. Both packages get the same normals and, for the
core functions, the same neighbourhoods; the end-to-end ``estimate_fpfh`` /
``estimate_pfh`` compare where the two kNN lists agree (their brute
distances are bitwise equal; the hash grid's differ in rounding).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
from pcl_tpu import features as jfeat
from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.features import fpfh as jfp
from pcl_tpu.search import bruteforce as jbf
from pcl_tpu.search import hashgrid as jhg

from pcl_tpu_torch.core.cloud import ATTR_NORMAL
from pcl_tpu_torch.core.cloud import make_cloud as tmake
from pcl_tpu_torch.features import fpfh as tfp

def _scene(seed=0, n=600):
    """tests/test_ia.py's asymmetric scene."""
    rng = np.random.default_rng(seed)
    n3 = n // 3
    a = np.stack([rng.uniform(0, 2, n3), rng.uniform(0, 1, n3),
                  0.2 * rng.uniform(0, 2, n3) ** 2], 1)
    b = np.stack([rng.uniform(0, 1, n3), np.zeros(n3), rng.uniform(0, 1, n3)], 1)
    t = rng.uniform(0, 2, n - 2 * n3)
    c = np.stack([t, 0.5 + 0.3 * np.sin(3 * t), 0.5 * t], 1)
    pts = np.concatenate([a, b, c]).astype(np.float32)
    return pts + rng.normal(scale=0.005, size=pts.shape).astype(np.float32)


@pytest.fixture(scope="module")
def clouds():
    """The scene padded to 640 rows, with the same normals on both: the JAX
    package's, each turned by ~0.01 rad at random. Neighbours that share a
    neighbourhood get equal estimated normals, and then only rounding picks
    the source point of their pair; the turn keeps such pairs few."""
    xyz = _scene()
    jc = jfeat.estimate_normals(jmake(jnp.asarray(xyz), capacity=640), k=12,
                                viewpoint=jnp.asarray([0.0, 0, 100]))
    nrm = np.asarray(jc.attrs["normal"])
    nrm = nrm + np.random.default_rng(3).normal(scale=0.01, size=nrm.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    nrm[600:] = 0.0
    jc = jc.with_attrs(normal=jnp.asarray(nrm))
    tc = tmake(xyz, capacity=640, device="cpu").with_attrs(**{ATTR_NORMAL: torch.from_numpy(nrm)})
    return jc, tc


def test_pair_features_match_jax():
    rng = np.random.default_rng(1)
    p1, p2 = rng.normal(size=(2, 4000, 3)).astype(np.float32)
    n1, n2 = rng.normal(size=(2, 4000, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
    p2[:5] = p1[:5]                                   # coincident points: not ok
    n2[5:10] = np.cross(p2[5:10] - p1[5:10], n1[5:10])  # and a few edge cases
    n1[10:15] = (p2[10:15] - p1[10:15]) / np.linalg.norm(p2[10:15] - p1[10:15], axis=1,
                                                          keepdims=True)
    want = jfp.pair_features(*(jnp.asarray(a) for a in (p1, n1, p2, n2)))
    got = tfp.pair_features(*(torch.from_numpy(a) for a in (p1, n1, p2, n2)))
    # rows 5-14 are frames that rounding decides: n2 perpendicular to d and
    # n1, or n1 on the connecting line
    sure = ~F.pair_unsure(p1, n1, p2, n2, 11)
    sure[5:15] = False          # the crafted degenerate frames, whatever the margin
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got[4].numpy()[sure], np.asarray(want[4])[sure])
    assert not got[4][:5].any()
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy()[sure], np.asarray(w)[sure], atol=1e-5)
    # bins equal away from the edges
    for f, lo, hi in ((0, -math.pi, math.pi), (1, -1.0, 1.0), (2, -1.0, 1.0)):
        w = np.asarray(want[f])
        away = sure
        np.testing.assert_array_equal(
            tfp._bin_index(got[f], lo, hi, 11).numpy()[away],
            np.asarray(jfp._bin_index(want[f], lo, hi, 11))[away])


def test_soft_hist_matches_jax():
    rng = np.random.default_rng(2)
    b = rng.integers(0, 11, size=(50, 16))
    w = rng.uniform(size=(50, 16)).astype(np.float32)
    want = jfp._soft_hist(jnp.asarray(b), jnp.asarray(w), 11)
    got = tfp._soft_hist(torch.from_numpy(b), torch.from_numpy(w), 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _firm_points(jc, idx, valid, nbins=11):
    """Per point: True when none of its pairs has a feature within ``F.EDGE``
    of a bin edge (JAX's values)."""
    return F.spfh_firm(np.asarray(jc.xyz), np.asarray(jc.attrs["normal"]), np.asarray(idx),
                       np.asarray(valid), nbins)


def test_spfh_and_fpfh_core_match_jax(clouds):
    jc, tc = clouds
    idx, d2, valid = jbf.knn(jc.xyz, jc.mask, jc.xyz, 16)
    valid = valid & jc.mask[:, None]
    jn = jc.attrs["normal"]
    want_s = jfp.spfh_from_neighborhoods(jc.xyz, jn, idx, valid, jc.xyz, jn)
    want_f = jfp.fpfh_from_spfh(want_s, idx, d2, valid)
    ti, td, tv = (torch.from_numpy(np.asarray(a)) for a in (idx, d2, valid))
    tn = tc.attrs[ATTR_NORMAL]
    got_s = tfp.spfh_from_neighborhoods(tc.xyz, tn, ti, tv, tc.xyz, tn)
    got_f = tfp.fpfh_from_spfh(got_s, ti, td, tv)
    firm = _firm_points(jc, idx, valid)
    assert firm.mean() > 0.9
    np.testing.assert_allclose(got_s.numpy()[firm], np.asarray(want_s)[firm], atol=1e-4)
    # FPFH mixes the neighbours' SPFH rows: firm when they all are
    firm_f = F.fpfh_firm(firm, np.asarray(idx), np.asarray(valid))
    assert firm_f.mean() > 0.7
    np.testing.assert_allclose(got_f.numpy()[firm_f], np.asarray(want_f)[firm_f], atol=1e-4)


def _same_lists(jidx, tidx):
    return np.all(np.asarray(jidx) == tidx.numpy(), axis=1)


@pytest.mark.parametrize("backend", ["bruteforce", "hashgrid"])
def test_estimate_fpfh_matches_jax(clouds, backend):
    jc, tc = clouds
    kw = dict(backend=backend, cell_size=0.4) if backend == "hashgrid" else {}
    want = np.asarray(jfeat.estimate_fpfh(jc, k=16, **kw))
    got = tfp.estimate_fpfh(tc, k=16, **kw)
    assert got.shape == (640, 33) and not got[600:].any()
    # where both kNN lists and every neighbour's list agree and no pair sits
    # on a bin edge
    if backend == "hashgrid":
        grid = jhg.build(jc.xyz, jc.mask, 0.4)
        jidx, _, jv, _ = jhg.knn(grid, jc.xyz, 16)
        tidx = tfp.hashgrid_mod.knn(tfp.hashgrid_mod.build(tc.xyz, tc.mask, 0.4), tc.xyz, 16)[0]
    else:
        jidx, _, jv = jbf.knn(jc.xyz, jc.mask, jc.xyz, 16)
        tidx = tfp.bruteforce.knn(tc.xyz, tc.mask, tc.xyz, 16)[0]
    jv = jv & jc.mask[:, None]
    same = _same_lists(jidx, tidx)
    firm = _firm_points(jc, jidx, jv) & same
    ok = F.fpfh_firm(firm, np.asarray(jidx), np.asarray(jv)) & np.asarray(jc.mask)
    assert ok.sum() > 0.6 * 600
    np.testing.assert_allclose(got.numpy()[ok], want[ok], atol=1e-4)
    sums = got.numpy()[:600].reshape(600, 3, 11).sum(-1)
    np.testing.assert_allclose(sums, 100.0, atol=1e-3)


def test_estimate_pfh_matches_jax(clouds):
    jc, tc = clouds
    want = np.asarray(jfeat.estimate_pfh(jc, k=8))
    got = tfp.estimate_pfh(tc, k=8)
    assert got.shape == (640, 125)
    jidx, _, jv = jbf.knn(jc.xyz, jc.mask, jc.xyz, 8)
    tidx = tfp.bruteforce.knn(tc.xyz, tc.mask, tc.xyz, 8)[0]
    # every unordered pair of the neighbourhood, JAX's features
    xyz, nrm = np.asarray(jc.xyz), np.asarray(jc.attrs["normal"])
    ic = np.clip(np.asarray(jidx), 0, 639)
    pp, nn = xyz[ic], nrm[ic]
    same_pt = np.all(pp[:, :, None] == pp[:, None], axis=-1)
    near = (F.pair_unsure(pp[:, :, None], nn[:, :, None], pp[:, None], nn[:, None], 5)
            & ~same_pt).any(axis=(1, 2))
    ok = _same_lists(jidx, tidx) & ~near & np.asarray(jc.mask)
    assert ok.sum() > 0.6 * 600
    np.testing.assert_allclose(got.numpy()[ok], want[ok], atol=1e-4)


def test_requires_normals():
    c = tmake(np.zeros((4, 3)), device="cpu")
    for fn in (tfp.estimate_fpfh, tfp.estimate_pfh):
        with pytest.raises(ValueError, match="requires normals"):
            fn(c)
    with pytest.raises(ValueError, match="requires cell_size"):
        tfp.estimate_fpfh(c.with_attrs(normal=torch.zeros(4, 3)), backend="hashgrid")
