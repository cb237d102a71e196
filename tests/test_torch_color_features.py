"""Parity of the port's intensity and colour features with the JAX package
on the CPU: the intensity gradient, intensity spin images, RIFT, PFHRGB,
PPFRGB and CPPF.

Both packages get the same points, the JAX package's normals and the same
intensity and RGB. Tolerances: the gradient is a 3x3 solve (LU in another
order) and is compared to 1e-5 of its largest norm; the intensity spin image
and RIFT are smooth votes, 1e-5 and 1e-4 (RIFT's angle is an ``arccos``,
which loses half its digits beside +-1); PFHRGB's two joint histograms move
a whole vote where a pair's feature or colour ratio lies on a bin edge
(ROADMAP C19), so rows are compared to 1e-4 where no pair lies within 1e-5
of one; PPF angles are ``arccos`` too: 1e-3 rad (``sqrt(2 ulp)``), 1e-5
elsewhere.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
import torch_feature_scenes as S
from pcl_tpu.features import color_features as jcf
from pcl_tpu.features import intensity as jin
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch import features as tfeat
from pcl_tpu_torch.features import color_features as tcf
from pcl_tpu_torch.features import intensity as tin

R = 0.35


@pytest.fixture(scope="module")
def scene():
    xyz = S.street_corner(0, 1500)
    return S.clouds(xyz, capacity=1536)


def test_intensity_gradient_matches_jax(scene):
    jc, tc = scene
    gj = np.asarray(jin.intensity_gradient(jc, R))
    gt = tin.intensity_gradient(tc, R).numpy()
    scale = np.linalg.norm(gj, axis=1).max()
    assert scale > 0.1
    assert np.abs(gt - gj).max() <= 1e-5 * scale
    for attr in ("intensity", "normal"):
        with pytest.raises(ValueError, match=attr):
            tin.intensity_gradient(tc.without_attrs(attr), R)


def test_intensity_spin_matches_jax(scene):
    jc, tc = scene
    for kw in ({}, {"distance_bins": 5, "intensity_bins": 6, "sigma": 0.5}):
        sj = np.asarray(jin.intensity_spin(jc, R, **kw))
        st = tin.intensity_spin(tc, R, **kw).numpy()
        assert np.abs(st - sj).max() <= 1e-5


def test_rift_matches_jax(scene):
    jc, tc = scene
    g = np.array(jin.intensity_gradient(jc, R))
    rj = np.asarray(jin.rift(jc, R, jnp.asarray(g)))
    rt = tin.rift(tc, R, torch.from_numpy(g)).numpy()
    assert rt.shape == (1536, 32)
    assert np.abs(rt - rj).max() <= 1e-4


def _pfhrgb_firm(jc, k=10, nbins=5, eps=1e-5):
    """Points none of whose neighbour pairs has a feature (C19) or colour
    ratio within ``eps`` of a bin edge."""
    idx, _, valid = (np.asarray(v) for v in jbf.knn(jc.xyz, jc.mask, jc.xyz, k))
    xyz, nrm, rgb = (np.asarray(v, np.float64) for v in (jc.xyz, jc.attrs["normal"],
                                                         jc.attrs["rgb"]))
    pp, nn, cc = xyz[idx], nrm[idx], rgb[idx]
    near = F.pair_unsure(pp[:, :, None], nn[:, :, None], pp[:, None], nn[:, None], nbins)
    c1, c2 = cc[:, :, None], cc[:, None]
    ratio = np.minimum(c1, c2) / np.maximum(np.maximum(c1, c2), 1e-9)
    near |= np.any(F.near_grid(ratio * nbins, eps * nbins) & (ratio < 1.0), -1)
    same = np.all(pp[:, :, None] == pp[:, None], -1)
    pair = valid[:, :, None] & valid[:, None] & np.triu(np.ones((k, k), bool), 1) & ~same
    return ~np.any(near & pair, axis=(1, 2)) & np.asarray(jc.mask)


def test_pfhrgb_matches_jax(scene):
    jc, tc = scene
    j = np.asarray(jcf.estimate_pfhrgb(jc))
    t = tcf.estimate_pfhrgb(tc).numpy()
    assert t.shape == (1536, 250)
    firm = _pfhrgb_firm(jc)
    print(S.count_line("PFHRGB", firm))
    assert firm.sum() >= 0.5 * 1500
    assert np.abs(t - j).max(1)[firm].max() <= 1e-4
    np.testing.assert_allclose(t[np.asarray(jc.mask)].sum(1), 200.0, atol=1e-2)


def _angle_tol(cosines):
    """1e-3 rad where an arccos argument lies within 1e-4 of +-1, 1e-5
    elsewhere."""
    return np.where(np.abs(cosines) > 1 - 1e-4, 1e-3, 1e-5)


def test_ppfrgb_features_match_jax():
    rng = np.random.default_rng(6)
    p1, p2, n1, n2 = rng.normal(size=(4, 500, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
    c1, c2 = rng.uniform(size=(2, 500, 3)).astype(np.float32)
    j = [np.asarray(v) for v in jcf.ppfrgb_features(*(jnp.asarray(a) for a in
                                                       (p1, n1, c1, p2, n2, c2)))]
    t = [v.numpy() for v in tcf.ppfrgb_features(*(torch.from_numpy(a) for a in
                                                   (p1, n1, c1, p2, n2, c2)))]
    assert len(t) == 7
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_cppf_matches_jax(scene):
    jc, tc = scene
    j = np.asarray(jcf.estimate_cppf(jc))
    t = tcf.estimate_cppf(tc).numpy()
    assert t.shape == (1536, 10, 10)
    # the three angles' arccos arguments, float64
    idx = np.asarray(jbf.knn(jc.xyz, jc.mask, jc.xyz, 11)[0])[:, 1:]
    x, n = (np.asarray(v, np.float64) for v in (jc.xyz, jc.attrs["normal"]))
    d = x[idx] - x[:, None]
    dn = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    cos = np.stack([np.sum(n[:, None] * dn, -1), np.sum(n[idx] * dn, -1),
                    np.sum(n[:, None] * n[idx], -1)], -1)
    assert np.all(np.abs(t[..., :3] - j[..., :3]) <= _angle_tol(cos))
    np.testing.assert_allclose(t[..., 3:], j[..., 3:], atol=1e-5)


def test_colour_features_require_rgb(scene):
    _, tc = scene
    for fn in (tcf.estimate_pfhrgb, tcf.estimate_cppf, tfeat.estimate_shot_color):
        with pytest.raises(ValueError, match="rgb"):
            fn(tc.without_attrs("rgb"), *(() if fn is not tfeat.estimate_shot_color else (R,)))
    assert math.isclose(float(tcf._color_ratios(torch.tensor(0.2), torch.tensor(0.4))), 0.5)
