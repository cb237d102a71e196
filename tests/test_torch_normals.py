"""Parity of pcl_tpu_torch's 3x3 eigensystems and normal estimation with
pcl_tpu.core.geometry and pcl_tpu.features.normals on the CPU.

Tolerances. Eigenvalues: 1e-5 of the largest. An eigenvector is defined only
up to sign and only where its eigenvalue is isolated, so eigenvectors are
compared as |v_port . v_jax| >= 1 - 1e-5 where the gaps to the neighbouring
eigenvalues exceed 1e-3 of the largest. Normals are compared after the
viewpoint flip, so with their sign: n_port . n_jax >= 1 - 1e-5 on
neighbourhoods with lambda1 - lambda0 > 1e-3 lambda2; curvature to 1e-5.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcl_tpu.search as jsearch
from pcl_tpu import features as jfeat
from pcl_tpu.core import geometry as jgeo
from pcl_tpu.core.cloud import Cloud as JCloud

import pcl_tpu_torch.search as tsearch
from pcl_tpu_torch import features as tfeat
from pcl_tpu_torch.core import geometry as tgeo
from pcl_tpu_torch.core.cloud import Cloud


def _spd(rng, n=500):
    X = rng.normal(size=(n, 3, 3)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1)
    A[0] = np.eye(3)                                   # all equal
    A[1] = np.diag([1.0, 1.0, 2.0])                    # a repeated pair
    A[2] = np.diag([0.0, 3.0, 3.0])
    A[3] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])  # rank one
    A[4] = np.diag([1e-6, 1.0, 4.0])                   # a thin plane
    A[5] = 0.0                                         # zero
    return A.astype(np.float32)


def _isolated(lam, k, rel=1e-3):
    scale = np.maximum(np.abs(lam).max(-1), 1e-30)
    gaps = []
    if k > 0:
        gaps.append(lam[:, k] - lam[:, k - 1])
    if k < 2:
        gaps.append(lam[:, k + 1] - lam[:, k])
    return np.min(gaps, axis=0) > rel * scale


def test_eigh33(rng):
    A = _spd(rng)
    lj, Vj = (np.asarray(x) for x in jgeo.eigh33(jnp.asarray(A)))
    lt, Vt = (x.numpy() for x in tgeo.eigh33(torch.from_numpy(A)))
    scale = np.maximum(np.abs(lj).max(-1, keepdims=True), 1e-30)
    assert np.all(np.abs(lt - lj) <= 1e-5 * scale)
    np.testing.assert_allclose(tgeo.eigvals33(torch.from_numpy(A)).numpy(),
                               np.asarray(jgeo.eigvals33(jnp.asarray(A))), rtol=0,
                               atol=1e-5 * float(scale.max()))
    # an orthonormal basis everywhere, degenerate cases included
    eye = np.broadcast_to(np.eye(3), Vt.shape)
    np.testing.assert_allclose(Vt.transpose(0, 2, 1) @ Vt, eye, atol=1e-5)
    for k in range(3):
        iso = _isolated(lj, k)
        assert iso.sum() > 450
        dots = np.abs(np.sum(Vt[:, :, k] * Vj[:, :, k], axis=1))
        assert np.all(dots[iso] >= 1 - 1e-5), k
    n0, l0 = tgeo.smallest_eigenvector33(torch.from_numpy(A))
    np.testing.assert_array_equal(n0.numpy(), Vt[:, :, 0])
    np.testing.assert_array_equal(l0.numpy(), lt)


def test_pca_and_demean(rng):
    xyz = (rng.normal(size=(400, 3)) * [3.0, 1.0, 0.2]).astype(np.float32)
    mask = rng.random(400) < 0.9
    mj, lj, Vj = (np.asarray(x) for x in jgeo.pca(jnp.asarray(xyz), jnp.asarray(mask)))
    mt, lt, Vt = (x.numpy() for x in tgeo.pca(torch.from_numpy(xyz), torch.from_numpy(mask)))
    np.testing.assert_allclose(mt, mj, atol=1e-6)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5 * lj.max())
    assert np.all(np.abs(np.sum(Vt * Vj, axis=0)) >= 1 - 1e-5)
    dj, cj = jgeo.demean(jnp.asarray(xyz), jnp.asarray(mask))
    dt, ct = tgeo.demean(torch.from_numpy(xyz), torch.from_numpy(mask))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    assert np.all(dt.numpy()[~mask] == 0.0)


def _scene(rng, n=2400, noise=0.002):
    """A floor, two walls and half a sphere: planar and curved surface."""
    u, v = rng.uniform(0, 2, size=(2, n)).astype(np.float32)
    part = rng.integers(0, 4, n)
    th = u * np.pi / 2
    ph = v * np.pi
    sphere = np.stack([1 + 0.5 * np.cos(ph) * np.sin(th), 1 + 0.5 * np.sin(ph) * np.sin(th),
                       0.5 * np.cos(th)], 1)
    xyz = np.select([part[:, None] == 0, part[:, None] == 1, part[:, None] == 2],
                    [np.stack([u, v, 0 * u], 1), np.stack([u, 0 * u, v], 1),
                     np.stack([0 * u, u, v], 1)], sphere)
    return (xyz + rng.normal(scale=noise, size=xyz.shape)).astype(np.float32)


def _pair(xyz, mask=None, width=0, height=1):
    mask = np.ones(len(xyz), bool) if mask is None else mask
    xyz = np.where(mask[:, None], xyz, 0.0).astype(np.float32)
    return (JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask), width=width, height=height),
            Cloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask), width=width,
                  height=height))


def _same_normals(got, want, surf_xyz, surf_mask, k, radius=None):
    """Normals and curvature agree; with a ``radius`` gate, points with a
    neighbour on the gate's edge (|d2 - r^2| within the 3e-5 by which the
    two matrix-product distances may differ at this scale) are skipped: the
    two sides may keep different neighbours there."""
    # each point's k neighbours and their conditioning, from JAX's lists
    idx, d2, valid = (np.asarray(x) for x in jsearch.knn(
        JCloud(xyz=jnp.asarray(surf_xyz), mask=jnp.asarray(surf_mask)),
        jnp.asarray(got.xyz.numpy()), k, backend="bruteforce"))
    keep = np.ones(len(idx), bool)
    if radius is not None:
        keep = ~np.any(valid & (np.abs(d2 - np.float32(radius) ** 2) <= 3e-5), axis=1)
        assert keep.mean() > 0.9
        valid = valid & (d2 <= np.float32(radius) ** 2)
    gn = got.attrs["normal"].numpy()[keep]
    wn = np.asarray(want.attrs["normal"])[keep]
    gc = got.attrs["curvature"].numpy()[keep]
    wc = np.asarray(want.attrs["curvature"])[keep]
    zero = np.all(wn == 0, axis=1)
    np.testing.assert_array_equal(np.all(gn == 0, axis=1), zero)
    _, cov, _ = jgeo.mean_and_covariance(jnp.asarray(surf_xyz[idx[keep]]),
                                         jnp.asarray(valid[keep]))
    lam = np.linalg.eigvalsh(np.asarray(cov, np.float64))
    well = (lam[:, 1] - lam[:, 0] > 1e-3 * lam[:, 2]) & ~zero
    assert well.sum() > 0.8 * (~zero).sum()
    # curvature to 1e-5 where the eigenvalues are 1e-2 of lambda2 apart; the
    # formula's arccos loses accuracy as two eigenvalues meet (measured up to
    # 1.5e-4 on three-point, nearly collinear neighbourhoods), so 5e-4 there
    apart = np.min(np.diff(lam, axis=1), axis=1) > 1e-2 * lam[:, 2]
    assert np.all(np.abs(gc - wc) <= np.where(apart, 1e-5, 5e-4)), np.abs(gc - wc).max()
    assert apart.sum() > 0.8 * (~zero).sum()
    dots = np.sum(gn * wn, axis=1)
    assert np.all(dots[well] >= 1 - 1e-5), np.sort(dots[well])[:5]


BACKENDS = [
    ("bruteforce", dict(backend="bruteforce")),
    ("auto_small", dict()),                              # brute below _AUTO_PAIRS
    ("cell_probed", dict(backend="cell")),               # the host probe picks size and cap
    ("cell_given", dict(backend="cell", cell_size=0.25, cell_cap=96)),
    ("radius", dict(backend="bruteforce", radius=0.12)),
    ("viewpoint", dict(viewpoint=np.float32([5.0, -3.0, 4.0]))),
]


@pytest.mark.parametrize("name,kw", BACKENDS, ids=[b[0] for b in BACKENDS])
def test_estimate_normals(rng, name, kw):
    xyz = _scene(rng)
    mask = rng.random(len(xyz)) < 0.95
    jc, tc = _pair(xyz, mask)
    k = 12
    jkw = dict(kw)
    tkw = dict(kw)
    if "viewpoint" in kw:
        jkw["viewpoint"] = jnp.asarray(kw["viewpoint"])
        tkw["viewpoint"] = torch.from_numpy(kw["viewpoint"])
    want = jfeat.estimate_normals(jc, k=k, **jkw)
    got = tfeat.estimate_normals(tc, k=k, **tkw)
    _same_normals(got, want, np.where(mask[:, None], xyz, 0), mask, k, kw.get("radius"))
    assert np.all(got.attrs["normal"].numpy()[~mask] == 0)


def test_estimate_normals_probe_engages_on_auto(rng, monkeypatch):
    """Above the port's one threshold ``search._AUTO_PAIRS`` an unorganized
    cloud probes its density and searches the cell list: the same as asking
    for backend='cell' (the JAX package's probe test hard-codes 1e9)."""
    jc, tc = _pair(_scene(rng, n=1500))
    calls = []
    probe = tsearch.auto_cell_params
    monkeypatch.setattr(tsearch, "auto_cell_params",
                        lambda *a, **k: calls.append(1) or probe(*a, **k))
    monkeypatch.setattr(tsearch, "_AUTO_PAIRS", 1e6)
    got = tfeat.estimate_normals(tc, k=10)
    assert calls
    want = jfeat.estimate_normals(jc, k=10, backend="cell")
    _same_normals(got, want, tc.xyz.numpy(), tc.mask.numpy(), 10)


def test_estimate_normals_with_surface(rng):
    xyz = _scene(rng)
    jq, tq = _pair(xyz[:300])
    js, ts = _pair(xyz[300:])
    want = jfeat.estimate_normals(jq, k=10, surface=js)
    got = tfeat.estimate_normals(tq, k=10, surface=ts)
    _same_normals(got, want, xyz[300:], np.ones(len(xyz) - 300, bool), 10)


def test_estimate_normals_organized(rng):
    H, W = 24, 32
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    z = 2.0 + 0.05 * np.sin(yy * 0.3) + 0.04 * np.cos(xx * 0.2)
    xyz = np.stack([(xx - W / 2) * 0.01 * z, (yy - H / 2) * 0.01 * z, z], -1).reshape(-1, 3)
    mask = rng.random(H * W) > 0.05
    jc, tc = _pair(xyz.astype(np.float32), mask, width=W, height=H)
    want = jfeat.estimate_normals(jc, k=9)
    got = tfeat.estimate_normals(tc, k=9)
    gn, wn = got.attrs["normal"].numpy(), np.asarray(want.attrs["normal"])
    np.testing.assert_allclose(got.attrs["curvature"].numpy(),
                               np.asarray(want.attrs["curvature"]), atol=1e-5)
    live = np.any(wn != 0, axis=1)
    assert live.sum() > 0.9 * H * W
    assert np.all(np.sum(gn * wn, axis=1)[live] >= 1 - 1e-5)
    with pytest.raises(ValueError, match="organized"):
        tfeat.estimate_normals(_pair(xyz.astype(np.float32))[1], k=9, backend="organized")


def test_normals_from_neighborhoods_and_flip(rng):
    nbr = _scene(rng, n=64 * 8).reshape(64, 8, 3)
    valid = rng.random((64, 8)) < 0.8
    valid[0, 2:] = False                 # two neighbours: no normal
    pts = nbr[:, 0]
    vp = np.float32([0.3, -2.0, 1.0])
    wn, wc = (np.asarray(x) for x in jfeat.normals.normals_from_neighborhoods(
        jnp.asarray(pts), jnp.asarray(nbr), jnp.asarray(valid), jnp.asarray(vp)))
    gn, gc = (x.numpy() for x in tfeat.normals.normals_from_neighborhoods(
        torch.from_numpy(pts), torch.from_numpy(nbr), torch.from_numpy(valid),
        torch.from_numpy(vp)))
    assert np.all(gn[0] == 0) and gc[0] == 0
    np.testing.assert_allclose(gc, wc, atol=1e-5)
    ok = np.any(wn != 0, axis=1)
    assert np.all(np.sum(gn * wn, axis=1)[ok] >= 1 - 1e-4)
    jc, tc = _pair(pts)
    jc = jc.with_attrs(normal=jnp.asarray(wn))
    tc = tc.with_attrs(normal=torch.from_numpy(wn.copy()))
    vp2 = np.float32([0.0, 5.0, 0.0])
    want = jfeat.flip_normals_towards_viewpoint(jc, jnp.asarray(vp2))
    got = tfeat.flip_normals_towards_viewpoint(tc, torch.from_numpy(vp2))
    np.testing.assert_array_equal(got.attrs["normal"].numpy(), np.asarray(want.attrs["normal"]))
