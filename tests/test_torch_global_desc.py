"""Parity of the port's clusters and global descriptors with the JAX package
on the CPU: label propagation, Euclidean clusters (brute and cell list) and
region growing; VFH; ESF through its core on the JAX package's own draws;
CVFH, OUR-CVFH, CRH and ``crh_align``; GASD and GASD colour.

Labels are compacted to ``0..C-1`` by each component's smallest index on
both sides and compared exactly (ROADMAP C48). Histograms of one descriptor
per cloud move by whole votes where a point's feature lies on a bin edge
(C19, C45): each is compared to 1e-4 plus two votes for every point or
sample that float64 finds within 1e-5 of an edge (the count is printed).
``crh_align``'s peaks are compared where the peak beats the runner-up by
1e-6 (``torch.fft`` rounds apart from XLA's, C47).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
import torch_feature_scenes as S
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.features import cvfh as jcv
from pcl_tpu.features import gasd as jga
from pcl_tpu.features import global_desc as jgd
from pcl_tpu.segmentation import clustering as jcl

from pcl_tpu_torch import segmentation as tseg
from pcl_tpu_torch.core.cloud import Cloud as TCloud
from pcl_tpu_torch.features import cvfh as tcv
from pcl_tpu_torch.features import gasd as tga
from pcl_tpu_torch.features import global_desc as tgd
from pcl_tpu_torch.segmentation import clustering as tcl

jrg = importlib.import_module("pcl_tpu.segmentation.region_growing")
trg = importlib.import_module("pcl_tpu_torch.segmentation.region_growing")


@pytest.fixture(scope="module")
def scene():
    xyz = S.street_corner(0, 1500)
    jc, tc = S.clouds(xyz, capacity=1536)
    return xyz, jc, tc


def test_propagate_labels_matches_jax():
    """A random sparse graph of many components, some rows masked."""
    rng = np.random.default_rng(4)
    n, k = 600, 4
    adj = rng.integers(0, n, (n, k)).astype(np.int32)
    adj = np.where(rng.uniform(size=(n, k)) < 0.35, adj, np.arange(n)[:, None]).astype(np.int32)
    valid = rng.uniform(size=(n, k)) < 0.9
    mask = rng.uniform(size=n) < 0.95
    for sweeps in (64, 2):
        j = np.asarray(jcl.propagate_labels(jnp.asarray(adj), jnp.asarray(valid),
                                            jnp.asarray(mask), sweeps))
        t = tcl.propagate_labels(torch.from_numpy(adj), torch.from_numpy(valid),
                                 torch.from_numpy(mask), sweeps)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)
    dj, cj = jcl._compact_labels(jnp.asarray(j), jnp.asarray(mask))
    dt, ct = tcl._compact_labels(t, torch.from_numpy(mask))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert int(ct) == int(cj)
    np.testing.assert_array_equal(tcl.labels_to_cluster_sizes(dt).numpy(),
                                  np.asarray(jcl.labels_to_cluster_sizes(dj)))


@pytest.mark.parametrize("backend,kw", [("auto", {}), ("cell", {}),
                                        ("auto", {"min_cluster_size": 20,
                                                  "max_cluster_size": 300})],
                         ids=["brute", "cell", "size-filter"])
def test_euclidean_clusters_match_jax(scene, backend, kw):
    _, jc, tc = scene
    lj, nj = jcl.euclidean_clusters(jc, 0.12, backend=backend, **kw)
    lt, nt = tseg.euclidean_clusters(tc, 0.12, backend=backend, **kw)
    assert 3 <= int(nj) < 400 and int(nt) == int(nj)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("kw", [{}, {"curvature_threshold": 0.02, "min_cluster_size": 30}])
def test_region_growing_matches_jax(scene, kw):
    _, jc, tc = scene
    lj, nj = jrg.region_growing(jc, **kw)
    lt, nt = tseg.region_growing(tc, **kw)
    assert int(nt) == int(nj) and int(nj) > 1
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    with pytest.raises(ValueError, match="normals"):
        trg.region_growing(tc.without_attrs("normal"))


def _vfh_unsure(jc, nbins=45):
    """Points whose VFH pair with the centroid a rounding can move to
    another bin (float64, the JAX package's inputs)."""
    xyz, nrm, m = (np.asarray(v, np.float64) for v in (jc.xyz, jc.attrs["normal"], jc.mask))
    m = m.astype(bool)
    c = xyz[m].mean(0)
    nc = nrm[m].mean(0)
    nc /= np.linalg.norm(nc)
    return int((F.pair_unsure(c[None], nc[None], xyz, nrm, nbins) & m).sum())


@pytest.mark.parametrize("vp", [None, (0.0, 3.0, -3.0)])
def test_vfh_matches_jax(scene, vp):
    _, jc, tc = scene
    j = np.asarray(jgd.estimate_vfh(jc, None if vp is None else jnp.asarray(vp)))
    t = tgd.estimate_vfh(tc, None if vp is None else torch.tensor(vp)).numpy()
    assert t.shape == (308,)
    n_unsure = _vfh_unsure(jc)
    print(f"VFH: {n_unsure} points within 1e-5 of a bin edge")
    incr = 100.0 / 1500
    assert np.abs(t - j).max() <= 1e-4 + 2 * incr * n_unsure
    for b in range(4):
        assert abs(t[45 * b:45 * (b + 1)].sum() - 100.0) < 1e-3
    assert abs(t[180:].sum() - 100.0) < 1e-3


def _jax_esf_draw(mask, key, n_samples=4096):
    """The JAX package's own draw (``global_desc.py:83-93``)."""
    probs = np.asarray(mask).astype(np.float32)
    probs = jnp.asarray(probs / max(probs.sum(), 1.0))
    return np.stack([np.asarray(jax.random.categorical(
        k, jnp.log(probs + 1e-30)[None, :].repeat(n_samples, 0))) for k in jax.random.split(
            key, 3)])


def test_esf_core_matches_jax_on_its_draws(scene):
    _, jc, tc = scene
    key = jax.random.PRNGKey(11)
    j = np.asarray(jgd.estimate_esf(jc, key))
    tri = _jax_esf_draw(jc.mask, key)
    t = tgd.estimate_esf_core(tc, torch.from_numpy(tri)).numpy()
    assert t.shape == (640,)
    # samples with a shape function within 1e-5 of a bin edge (float64)
    x = np.asarray(jc.xyz, np.float64)
    a, b, c = x[tri[0]], x[tri[1]], x[tri[2]]
    m = np.asarray(jc.mask)
    scale = np.max(np.linalg.norm(np.where(m[:, None], x, 0) - x.mean(0), axis=1))
    d = [np.linalg.norm(p - q, axis=1) / (2 * scale) for p, q in ((a, b), (b, c), (c, a))]
    near = sum(F.near_grid(v * 64, 1e-5 * 64) for v in d + [(d[0] + d[1] + d[2]) / 3])
    n_unsure = int((near > 0).sum())
    print(f"ESF: {n_unsure} of 4096 samples within 1e-5 of a bin edge")
    assert np.abs(t - j).max() <= 1e-4 + 2 * 100.0 / 4096 * n_unsure
    # the sampler feeds the core its draw
    g = torch.Generator().manual_seed(5)
    drawn = tgd.draw_esf_samples(tc.mask, 4096, torch.Generator().manual_seed(5))
    assert drawn.shape == (3, 4096) and bool(tc.mask[drawn].all())
    assert torch.equal(tgd.estimate_esf(tc, g), tgd.estimate_esf_core(tc, drawn))


def test_cvfh_and_our_cvfh_match_jax(scene):
    _, jc, tc = scene
    for jf, tf in ((jcv.estimate_cvfh, tcv.estimate_cvfh),
                   (jcv.estimate_our_cvfh, tcv.estimate_our_cvfh)):
        j = jf(jc, min_points=30)
        t = tf(tc, min_points=30)
        assert type(t).__name__ == "ClusteredSignatures"
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        assert int(t.valid.sum()) >= 1
        np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), atol=1e-6)
        np.testing.assert_allclose(t.histograms.numpy(), np.asarray(j.histograms), atol=1e-4)


def test_crh_and_crh_align_match_jax(scene):
    _, jc, tc = scene
    hj = np.array(jcv.estimate_crh(jc))
    ht = tcv.estimate_crh(tc)
    np.testing.assert_allclose(ht.numpy(), hj, atol=1e-6)
    for shift in (0, 17, 61):
        b = np.roll(hj, -shift)
        aj, sj = (np.asarray(v) for v in jcv.crh_align(jnp.asarray(hj), jnp.asarray(b), 3))
        at, st = (v.numpy() for v in tcv.crh_align(torch.from_numpy(hj), torch.from_numpy(b), 3))
        corr = np.sort(np.real(np.fft.ifft(np.fft.fft(hj) * np.conj(np.fft.fft(b)))))[::-1]
        firm = corr[0] - corr[1] > 1e-6
        assert firm
        want = shift / 90 * 2 * math.pi
        assert abs(at[0] - (want - 2 * math.pi if want >= math.pi else want)) < 1e-6
        assert at[0] == aj[0]
        np.testing.assert_allclose(st, sj, atol=1e-6)


def test_gasd_matches_jax(scene):
    _, jc, tc = scene
    Tj = np.asarray(jga.gasd_reference_frame(jc))
    Tt = tga.gasd_reference_frame(tc).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    gj = np.asarray(jga.estimate_gasd(jc))
    gt = tga.estimate_gasd(tc).numpy()
    assert gt.shape == (512,)
    # trilinear votes are continuous across cell edges
    np.testing.assert_allclose(gt, gj, atol=1e-5)
    cj = np.asarray(jga.estimate_gasd_color(jc))
    ct = tga.estimate_gasd_color(tc).numpy()
    assert ct.shape == (768,)
    # a point within 1e-5 of a cell or hue edge may vote in the next bin
    x = np.asarray(jc.xyz, np.float64) @ Tj[:3, :3].T.astype(np.float64) + Tj[:3, 3]
    m = np.asarray(jc.mask)
    r = np.max(np.abs(x[m])) * 1.0001
    n_unsure = int((np.any(F.near_grid((x / r * 0.5 + 0.5) * 4, 1e-5), 1) & m).sum())
    print(f"GASD colour: {n_unsure} points within 1e-5 of a cell edge")
    assert np.abs(ct - cj).max() <= 1e-6 + 2 * n_unsure / 1500
    with pytest.raises(ValueError, match="rgb"):
        tga.estimate_gasd_color(tc.without_attrs("rgb"))


def test_cluster_descriptors_on_masked_clouds(scene):
    """The global descriptors of each Euclidean cluster as the
    cluster-recognition tutorial computes them: a cloud masked to the
    cluster, the same on both sides."""
    _, jc, tc = scene
    lj, _ = jcl.euclidean_clusters(jc, 0.12, min_cluster_size=50)
    labels = np.asarray(lj)
    ids = [c for c in np.unique(labels) if c >= 0][:3]
    assert ids
    for c in ids:
        m = labels == c
        jsub = JCloud(xyz=jc.xyz, mask=jnp.asarray(m), attrs=jc.attrs)
        tsub = TCloud(xyz=tc.xyz, mask=torch.from_numpy(m), attrs=tc.attrs)
        n_unsure = _vfh_unsure(jsub)
        assert np.abs(tgd.estimate_vfh(tsub).numpy()
                      - np.asarray(jgd.estimate_vfh(jsub))).max() \
            <= 1e-4 + 2 * 100.0 / m.sum() * n_unsure
        np.testing.assert_allclose(tga.estimate_gasd(tsub).numpy(),
                                   np.asarray(jga.estimate_gasd(jsub)), atol=1e-5)
