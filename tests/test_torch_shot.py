"""Parity of pcl_tpu_torch.features.shot (SHOT's LRF, the interpolated,
hard and colour descriptors, the organized branch, the cell-list backend and
``surface=``) with pcl_tpu.features.shot on the CPU.

Both packages get the same points and the JAX package's normals. Their
brute distances are bitwise equal (ROADMAP F2), so the neighbour lists are
the same; what differs is rounding: the eigenvectors (``eigh33``'s closed
form in another order, C9), the dot products, and the histogram sums (a
split one-hot product in JAX, ``index_put_`` in the port, C44). Every
decision of SHOT turns on a sign, a comparison or a floor (C45), so rows are
compared where ``torch_feature_scenes`` finds every decision further than
1e-4 (in radii, bins or radians) from its cut and the LRF's eigenvalues 5%
apart; the other rows are counted and printed. Tolerances on the compared
rows: frames 1e-4, the interpolated descriptor 2e-5 (unit rows; measured
2.8e-6), the hard and colour descriptors 1e-6 (the same counts, the norm
rounded apart).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
import torch_feature_scenes as S
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.features import shot as jshot
from pcl_tpu.search import bruteforce as jbf
from pcl_tpu.search import organized as jorg

from pcl_tpu_torch.core.cloud import Cloud as TCloud
from pcl_tpu_torch.features import shot as tshot

R = 0.35


@pytest.fixture(scope="module")
def scene():
    xyz = S.street_corner(0, 1500)
    jc, tc = S.clouds(xyz, capacity=1536)
    return xyz, jc, tc


def _np(c):
    return {k: np.array(v) for k, v in (("xyz", c.xyz), ("mask", c.mask), *c.attrs.items())}


def test_local_reference_frames_matches_jax(scene):
    _, jc, _ = scene
    a = _np(jc)
    idx, d2, valid, _ = (np.asarray(v) for v in jbf.radius(jc.xyz, jc.mask, jc.xyz, R, cap=64))
    valid = valid & a["mask"][:, None] & (d2 > 0)
    nbr = a["xyz"][idx]
    fj, okj = (np.asarray(v) for v in jshot.local_reference_frames(
        jnp.asarray(a["xyz"]), jnp.asarray(nbr), jnp.asarray(valid), R))
    ft, okt = (v.numpy() for v in tshot.local_reference_frames(
        torch.from_numpy(a["xyz"]), torch.from_numpy(nbr), torch.from_numpy(valid), R))
    np.testing.assert_array_equal(okt, okj)
    _, firm = F.hard_lrf64(a["xyz"], idx, valid, R)
    firm &= okj
    print(S.count_line("LRF", firm))
    assert firm.sum() >= 0.6 * a["mask"].sum()
    assert np.abs(ft - fj)[firm].max() <= 1e-4


def _interp_firm(jc, qc, k, backend="auto"):
    """The JAX package's neighbour lists of ``qc``'s points in ``jc`` and the
    rows whose decisions are firm."""
    if backend == "organized":
        H, W = qc.height, qc.width
        idx, d2, valid = jorg.self_knn(qc.xyz.reshape(H, W, 3), qc.mask.reshape(H, W), k,
                                       window=9 if k <= 24 else 13)
    else:
        idx, d2, valid = jbf.knn(jc.xyz, jc.mask, qc.xyz, k)
    idx, d2, valid = (np.asarray(v) for v in (idx, d2, valid))
    valid = valid & np.asarray(qc.mask)[:, None]
    return F.shot_firm(np.asarray(jc.xyz), np.asarray(jc.attrs["normal"]), np.asarray(qc.xyz),
                       idx, d2, valid, R)


@pytest.mark.parametrize("backend", ["auto", "cell", "bruteforce"])
def test_shot_interpolated_matches_jax(scene, backend):
    _, jc, tc = scene
    j = np.asarray(jshot.estimate_shot_interpolated(jc, R, k=128, backend=backend))
    t = tshot.estimate_shot_interpolated(tc, R, k=128, backend=backend).numpy()
    firm = _interp_firm(jc, jc, 128) & np.asarray(jc.mask)
    print(S.count_line(f"SHOT ({backend})", firm))
    assert firm.sum() >= 0.5 * np.asarray(jc.mask).sum()
    assert np.abs(t - j)[firm].max() <= 2e-5
    np.testing.assert_array_equal(t[~np.asarray(jc.mask)], 0.0)
    # the compared rows are unit rows, and so are the rest of the port's
    live = np.linalg.norm(t, axis=1) > 0
    np.testing.assert_allclose(np.linalg.norm(t[live], axis=1), 1.0, atol=1e-5)


def test_shot_surface_matches_jax(scene):
    """Descriptors at every 7th point, neighbourhoods and normals from the
    whole cloud (PCL's setSearchSurface)."""
    xyz, jc, tc = scene
    sel = np.arange(0, len(xyz), 7)
    jq = JCloud(xyz=jnp.asarray(xyz[sel]), mask=jnp.ones(len(sel), bool))
    tq = TCloud(xyz=torch.from_numpy(xyz[sel]), mask=torch.ones(len(sel), dtype=torch.bool))
    j = np.asarray(jshot.estimate_shot_interpolated(jq, R, k=128, surface=jc))
    t = tshot.estimate_shot_interpolated(tq, R, k=128, surface=tc).numpy()
    firm = _interp_firm(jc, jq, 128)
    print(S.count_line("SHOT (surface)", firm))
    assert firm.sum() >= 0.5 * len(sel)
    assert np.abs(t - j)[firm].max() <= 2e-5
    # the same rows as the descriptors of the whole cloud
    whole = tshot.estimate_shot_interpolated(tc, R, k=128).numpy()[sel]
    assert np.abs(t - whole).max() <= 1e-6


def _organized(H=24, W=32, seed=1):
    """An organized H x W frame of a wavy wall 2 m in front of a camera."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    x = (u - W / 2) * 0.03
    y = (v - H / 2) * 0.03
    z = 2.0 + 0.08 * np.sin(4 * x) * np.cos(3 * y) + rng.normal(scale=0.002, size=x.shape)
    xyz = np.stack([x * z / 2, y * z / 2, z], -1).reshape(-1, 3).astype(np.float32)
    mask = np.ones(H * W, bool)
    mask[rng.choice(H * W, 20, replace=False)] = False
    xyz[~mask] = 0.0
    return xyz, mask, H, W


def test_shot_organized_matches_jax():
    """An organized self-query takes the window search (``backend="auto"``)."""
    from pcl_tpu import features as jfeat

    xyz, mask, H, W = _organized()
    jc = JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask), width=W, height=H)
    jc = jfeat.estimate_normals(jc, k=12, viewpoint=jnp.zeros(3))
    tc = TCloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask),
                attrs={"normal": torch.from_numpy(np.asarray(jc.attrs["normal"]))},
                width=W, height=H)
    j = np.asarray(jshot.estimate_shot_interpolated(jc, R, k=24))
    t = tshot.estimate_shot_interpolated(tc, R, k=24).numpy()
    firm = _interp_firm(jc, jc, 24, backend="organized") & mask
    print(S.count_line("SHOT (organized)", firm))
    assert firm.sum() >= 0.5 * mask.sum()
    assert np.abs(t - j)[firm].max() <= 2e-5


def _hard_inputs(jc, k):
    a = _np(jc)
    idx, d2, valid, _ = (np.asarray(v) for v in jbf.radius(jc.xyz, jc.mask, jc.xyz, R, cap=k))
    return a, idx, valid & a["mask"][:, None] & (d2 > 0)


@pytest.mark.parametrize("n_cos_bins", [11, 8])
def test_shot_hard_matches_jax(scene, n_cos_bins):
    _, jc, tc = scene
    j = np.asarray(jshot.estimate_shot_hard(jc, R, k=64, n_cos_bins=n_cos_bins))
    t = tshot.estimate_shot_hard(tc, R, k=64, n_cos_bins=n_cos_bins).numpy()
    a, idx, valid = _hard_inputs(jc, 64)
    firm = F.hard_firm(a["xyz"], a["normal"], idx, valid, R, n_cos_bins) & a["mask"]
    print(S.count_line(f"SHOT hard ({n_cos_bins} bins)", firm))
    assert firm.sum() >= 0.5 * a["mask"].sum()
    assert np.abs(t - j)[firm].max() <= 1e-6
    # estimate_shot dispatches to the hard variant for any other bin count
    if n_cos_bins != 11:
        assert torch.equal(tshot.estimate_shot(tc, R, k=64, n_cos_bins=n_cos_bins),
                           torch.from_numpy(t))


def test_shot_color_matches_jax(scene):
    _, jc, tc = scene
    j = np.asarray(jshot.estimate_shot_color(jc, R, k=64))
    t = tshot.estimate_shot_color(tc, R, k=64).numpy()
    assert t.shape == (1536, 1344)
    a, idx, valid = _hard_inputs(jc, 64)
    lab = np.asarray(jshot._rgb_to_lab(jnp.asarray(a["rgb"])))
    firm = F.hard_firm(a["xyz"], a["normal"], idx, valid, R, lab=lab) & a["mask"]
    print(S.count_line("SHOT colour", firm))
    assert firm.sum() >= 0.5 * a["mask"].sum()
    assert np.abs(t - j)[firm].max() <= 1e-6


def test_estimate_shot_defaults_to_interpolated(scene):
    _, _, tc = scene
    assert torch.equal(tshot.estimate_shot(tc, R),
                       tshot.estimate_shot_interpolated(tc, R, k=64))


def test_shot_requires_normals(scene):
    _, _, tc = scene
    bare = tc.without_attrs("normal")
    for fn in (tshot.estimate_shot_interpolated, tshot.estimate_shot_hard,
               tshot.estimate_shot_color):
        with pytest.raises(ValueError, match="normals"):
            fn(bare, R)
