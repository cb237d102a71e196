"""Parity of the port's Harris 3-D, SUSAN and SIFT keypoints with the JAX
package on the CPU, on both of SIFT's interfaces.

Both packages get the same points and the JAX package's normals. A
keypoint is a comparison of responses: with the threshold and with every
neighbour's response (the lowest index winning a tie). The responses are
compared to 1e-6 of their scale for Harris and Noble (a determinant and a
trace); Lowe and Tomasi take eigenvalues from ``eigh33``'s closed form
(ROADMAP C9: its ``arccos`` loses accuracy where eigenvalues meet), so
theirs are compared to 1e-6 where the normals' covariance has its
eigenvalues 1% apart and to 1e-3 elsewhere; masks are compared where every such comparison clears that margin.
SIFT's octaves are voxel grids (bitwise, C11) and its difference of
Gaussians is compared to 1e-6; its keypoint cloud equals the JAX package's.
The mask API snaps each keypoint to its nearest input point: the JAX
package's CPU 1-NN takes the matmul identity ``|q|^2 + |t|^2 - 2 q.t``, the
port the exact distance (C1), so snaps are compared where the nearest point
beats the runner-up by 8 ulp of ``|q|^2 + |t|^2``.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float64_cuts as F
import torch_feature_scenes as S
from pcl_tpu.keypoints import harris as jh
from pcl_tpu.keypoints import sift as jsi
from pcl_tpu.keypoints import susan as js
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch import keypoints as tkp
from pcl_tpu_torch.keypoints import sift as tsi
from pcl_tpu_torch.search import bruteforce as tbf

R = 0.2


@pytest.fixture(scope="module")
def scene():
    xyz = S.street_corner(0, 1500)
    jc, tc = S.clouds(xyz, capacity=1536)
    idx, _, valid, _ = (np.asarray(v) for v in jbf.radius(jc.xyz, jc.mask, jc.xyz, R, cap=48))
    return jc, tc, idx, valid & np.asarray(jc.mask)[:, None]


def _nms_firm(resp, idx, valid, mask, threshold, tol):
    """Points whose keypoint decision no error of ``tol`` (per point) in the
    responses can change: the response clearly below the threshold, or
    clearly above it and clear of every other neighbour's response."""
    r = np.where(mask, resp.astype(np.float64), -np.inf)
    tol = np.broadcast_to(tol, r.shape)
    other = valid & (idx != np.arange(len(r))[:, None])
    with np.errstate(invalid="ignore"):
        apart = np.abs(r[idx] - r[:, None]) > tol[idx] + tol[:, None]
    above = ~np.any(other & ~apart, axis=1) & (r > threshold + tol)
    return above | (r < threshold - tol) | ~mask


def _eigen_tol(jc, idx, valid, scale):
    """Per point: 2e-5 of the largest response where the normals'
    covariance has its eigenvalues 5% apart, else 3e-4: the closed form's
    eigenvalues err by up to 2.3e-4 of the largest (C9), which is at most
    the trace, 1 for unit normals."""
    n = np.asarray(jc.attrs["normal"], np.float64)[idx]
    w = valid.astype(np.float64)
    C = np.einsum("nk,nki,nkj->nij", w, n, n) / np.maximum(w.sum(1), 1)[:, None, None]
    return np.where(F.isolated(np.linalg.eigvalsh(C), 0.05), 2e-5 * scale, 3e-4)


@pytest.mark.parametrize("response", ["harris", "noble", "lowe", "tomasi", "curvature"])
def test_harris3d_matches_jax(scene, response):
    jc, tc, idx, valid = scene
    mj, rj = (np.asarray(v) for v in jh.harris3d_keypoints(jc, R, response=response))
    mt, rt = (v.numpy() for v in tkp.harris3d_keypoints(tc, R, response=response))
    scale = np.abs(rj).max()
    eigen = response in ("lowe", "tomasi")
    tol = _eigen_tol(jc, idx, valid, scale) if eigen else np.full(len(rj), 1e-6 * scale)
    assert np.all(np.abs(rt - rj) <= tol)
    firm = _nms_firm(rj, idx, valid, np.asarray(jc.mask), 0.0, tol)
    print(S.count_line(f"Harris ({response})", firm))
    # flat patches give Lowe and Tomasi responses at the eigenvalues' error
    assert firm.mean() >= (0.25 if eigen else 0.5) and mj[firm].sum() >= 5
    np.testing.assert_array_equal(mt[firm], mj[firm])


def test_harris3d_threshold_and_errors(scene):
    jc, tc, _, _ = scene
    mj, _ = jh.harris3d_keypoints(jc, R, threshold=0.02)
    mt, _ = tkp.harris3d_keypoints(tc, R, threshold=0.02)
    assert int(mt.sum()) == int(np.asarray(mj).sum())
    with pytest.raises(ValueError, match="unknown response"):
        tkp.harris3d_keypoints(tc, R, response="sobel")
    with pytest.raises(ValueError, match="curvature"):
        tkp.harris3d_keypoints(tc.without_attrs("curvature"), R, response="curvature")
    with pytest.raises(ValueError, match="normals"):
        tkp.harris3d_keypoints(tc.without_attrs("normal"), R)


@pytest.mark.parametrize("kw", [{}, {"angular_threshold": 0.5, "geometric_threshold": 0.6}])
def test_susan_matches_jax(scene, kw):
    jc, tc, idx, valid = scene
    mj, rj = (np.asarray(v) for v in js.susan_keypoints(jc, R, **kw))
    mt, rt = (v.numpy() for v in tkp.susan_keypoints(tc, R, **kw))
    # the response is a ratio of counts: equal unless a normal lies on the
    # angular threshold, which the equal masks and responses below rule out
    np.testing.assert_allclose(rt, rj, atol=1e-6)
    assert mj.sum() >= 5
    np.testing.assert_array_equal(mt, mj)


@pytest.fixture(scope="module")
def sift_scene():
    xyz = S.street_corner(1, 3000)
    return S.clouds(xyz, capacity=3072)


def test_sift_octaves_match_jax(sift_scene):
    """One octave's difference of Gaussians and extrema on the same input."""
    jc, tc = sift_scene
    from pcl_tpu.filters import voxel_downsample as jvox
    from pcl_tpu_torch.filters import voxel_downsample as tvox
    dj, dt = jvox(jc, 0.05), tvox(tc, 0.05)
    np.testing.assert_array_equal(dt.mask.numpy(), np.asarray(dj.mask))
    np.testing.assert_array_equal(dt.xyz.numpy(), np.asarray(dj.xyz))
    n = int(np.asarray(dj.mask).sum())
    f = np.array(dj.attrs["intensity"])[:n]
    ej, sj = jsi._octave_extrema(dj.xyz[:n], dj.mask[:n], jnp.asarray(f), jnp.float32(0.05), 3,
                                 jnp.float32(1e-3), 512, 25)
    et, st = tsi._octave_extrema(dt.xyz[:n], dt.mask[:n], torch.from_numpy(f), 0.05, 3, 1e-3,
                                 512, 25)
    np.testing.assert_array_equal(st, np.asarray(sj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert et.any()


def test_sift_keypoints_cloud_matches_jax(sift_scene):
    jc, tc = sift_scene
    for kw in ({}, {"n_octaves": 4, "min_contrast": 5e-3}):
        kj = jsi.sift_keypoints_cloud(jc, 0.05, **kw)
        kt = tsi.sift_keypoints_cloud(tc, 0.05, **kw)
        assert int(kt.mask.sum()) == int(np.asarray(kj.mask).sum()) >= 10
        np.testing.assert_array_equal(kt.xyz.numpy(), np.asarray(kj.xyz))
        np.testing.assert_array_equal(kt.attrs["scale"].numpy(), np.asarray(kj.attrs["scale"]))
    # a field given by name, and octaves that end below 25 points
    kj = jsi.sift_keypoints_cloud(jc, 0.5, field_attr="curvature")
    kt = tsi.sift_keypoints_cloud(tc, 0.5, field_attr="curvature")
    np.testing.assert_array_equal(kt.xyz.numpy(), np.asarray(kj.xyz))


def test_sift_keypoints_mask_matches_jax(sift_scene):
    jc, tc = sift_scene
    field = np.asarray(jc.xyz)[:, 1].copy()
    for kw in ({}, {"field": field}):
        jkw = {"field": jnp.asarray(field)} if kw else {}
        tkw = {"field": torch.from_numpy(field)} if kw else {}
        mj, sj = (np.asarray(v) for v in jsi.sift_keypoints(jc, 0.05, **jkw))
        mt, st = (v.numpy() for v in tsi.sift_keypoints(tc, 0.05, **tkw))
        kp = tsi.sift_keypoints_cloud(
            tc if not kw else tc.with_attrs(sift_field=torch.from_numpy(field)), 0.05,
            field_attr=None if not kw else "sift_field")
        q = kp.xyz.numpy()[kp.mask.numpy()].astype(np.float64)
        x = np.asarray(jc.xyz, np.float64)
        m = np.asarray(jc.mask)
        d2 = np.where(m[None], ((q[:, None] - x[None]) ** 2).sum(-1), np.inf)
        order = np.argsort(d2, axis=1)[:, :2]
        gap = np.take_along_axis(d2, order, 1)
        ulp = 8 * 2.0 ** -24 * ((q ** 2).sum(1) + (x[order[:, 0]] ** 2).sum(1))
        firm_kp = (gap[:, 1] - gap[:, 0]) > ulp
        print(f"SIFT snap: {int(firm_kp.sum())} of {len(q)} keypoints firm")
        # every input point that a firm keypoint snaps to, and no other
        # keypoint could snap to, agrees
        sure = order[firm_kp, 0]
        unsure = np.unique(order[~firm_kp].ravel())
        sure = np.setdiff1d(sure, unsure)
        assert len(sure) >= 5
        assert mt[sure].all() and mj[sure].all()
        np.testing.assert_array_equal(st[sure], sj[sure])
        # the port's mask and scales from its own snap: a keypoint that is
        # the centroid of a two-point voxel lies equally near both (C1)
        snap = tbf.nn1(tc.xyz, tc.mask, kp.xyz)[0].numpy()[kp.mask.numpy()]
        np.testing.assert_array_equal(np.nonzero(mt)[0], np.unique(snap))
        sc = kp.attrs["scale"].numpy()[kp.mask.numpy()]
        for i in np.unique(snap):
            assert st[i] == sc[snap == i].max()
