"""Parity of pcl_tpu_torch's core (Cloud, transforms, geometry, morton keys,
estimation) with pcl_tpu on the CPU: the same seeded numpy inputs through
both, compared with the tolerance stated at each assert."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcl_tpu.core import cloud as jcloud
from pcl_tpu.core import geometry as jgeo
from pcl_tpu.core import transforms as jtf
from pcl_tpu.octree import linear as jlinear
from pcl_tpu.registration import estimation as jest

from pcl_tpu_torch.core import cloud as tcloud
from pcl_tpu_torch.core import geometry as tgeo
from pcl_tpu_torch.core import transforms as ttf
from pcl_tpu_torch.octree import linear as tlinear
from pcl_tpu_torch.registration import estimation as test_

CPU = "cpu"
# float32 elementwise math through two frameworks: a few ulps of O(1) values
ATOL = 2e-6


def T(a):
    return torch.as_tensor(np.array(a))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.asarray(jtf.quat_to_matrix(jnp.asarray(q)))


def _transforms(rng, n):
    R = _rotations(rng, n)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return np.asarray(jtf.from_rt(jnp.asarray(R), jnp.asarray(t)))


# ---------------------------------------------------------------------------
# Cloud
# ---------------------------------------------------------------------------

def _pair_clouds(rng):
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    mask = rng.uniform(size=40) > 0.3
    nrm = rng.normal(size=(40, 3)).astype(np.float32)
    j = jcloud.make_cloud(jnp.asarray(xyz), jnp.asarray(mask), {"normal": jnp.asarray(nrm)})
    t = tcloud.make_cloud(xyz, mask, {"normal": nrm}, device=CPU)
    return j, t


def _same_cloud(j, t):
    # exact: these operations only move and zero rows
    np.testing.assert_array_equal(N(t.xyz), np.asarray(j.xyz))
    np.testing.assert_array_equal(N(t.mask), np.asarray(j.mask))
    assert set(t.attrs) == set(j.attrs)
    for k in j.attrs:
        np.testing.assert_array_equal(N(t.attrs[k]), np.asarray(j.attrs[k]))
    assert (t.width, t.height) == (j.width, j.height)


class TestCloud:
    def test_make_cloud_zeroes_invalid_rows(self, rng):
        j, t = _pair_clouds(rng)
        _same_cloud(j, t)
        assert int(t.count) == int(j.count)

    @pytest.mark.parametrize("op", ["with_mask", "take", "take_valid", "pad_to",
                                    "compact", "concat"])
    def test_ops_match(self, rng, op):
        j, t = _pair_clouds(rng)
        if op == "with_mask":
            m = rng.uniform(size=40) > 0.5
            _same_cloud(j.with_mask(jnp.asarray(m)), t.with_mask(T(m)))
        elif op == "take":
            idx = rng.integers(-5, 50, size=25).astype(np.int32)
            _same_cloud(j.take(jnp.asarray(idx)), t.take(T(idx)))
        elif op == "take_valid":
            idx = rng.integers(0, 40, size=25).astype(np.int32)
            v = rng.uniform(size=25) > 0.4
            _same_cloud(j.take(jnp.asarray(idx), jnp.asarray(v)), t.take(T(idx), T(v)))
        elif op == "pad_to":
            _same_cloud(j.pad_to(64), t.pad_to(64))
            with pytest.raises(ValueError):
                t.pad_to(10)
        elif op == "compact":
            perm_j, cnt_j = jcloud.compact_indices(j.mask)
            perm_t, cnt_t = tcloud.compact_indices(t.mask)
            np.testing.assert_array_equal(N(perm_t), np.asarray(perm_j))
            assert int(cnt_t) == int(cnt_j)
            _same_cloud(jcloud.compact(j), tcloud.compact(t))
        else:
            xyz = rng.normal(size=(7, 3)).astype(np.float32)
            rgb = rng.uniform(size=(7, 3)).astype(np.float32)
            j2 = jcloud.make_cloud(jnp.asarray(xyz), attrs={"rgb": jnp.asarray(rgb)})
            t2 = tcloud.make_cloud(xyz, attrs={"rgb": rgb}, device=CPU)
            _same_cloud(jcloud.concat(j, j2), tcloud.concat(t, t2))

    def test_from_numpy_to_numpy(self, rng):
        xyz = rng.normal(size=(30, 3)).astype(np.float32)
        xyz[4] = np.nan
        xyz[9, 2] = np.inf
        inten = rng.normal(size=30)
        j = jcloud.from_numpy(xyz, {"intensity": inten}, capacity=40)
        t = tcloud.from_numpy(xyz, {"intensity": inten}, capacity=40, device=CPU)
        _same_cloud(j, t)
        xj, aj = jcloud.to_numpy(j)
        xt, at = tcloud.to_numpy(t)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(at["intensity"], aj["intensity"])
        assert at["intensity"].dtype == np.float32


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

class TestTransforms:
    def test_rigid_helpers(self, rng):
        Ts = _transforms(rng, 5)
        pts = rng.normal(size=(5, 20, 3)).astype(np.float32)
        np.testing.assert_allclose(N(ttf.invert_rigid(T(Ts))),
                                   np.asarray(jtf.invert_rigid(jnp.asarray(Ts))), atol=ATOL)
        np.testing.assert_allclose(
            N(ttf.transform_points(T(Ts), T(pts))),
            np.asarray(jtf.transform_points(jnp.asarray(Ts), jnp.asarray(pts))), atol=1e-5)
        R, t = Ts[:, :3, :3], Ts[:, :3, 3]
        np.testing.assert_array_equal(N(ttf.from_rt(T(R), T(t))),
                                      np.asarray(jtf.from_rt(jnp.asarray(R), jnp.asarray(t))))

    def test_transform_cloud_rotates_normals(self, rng):
        j, t = _pair_clouds(rng)
        Tm = _transforms(rng, 1)[0]
        oj = jtf.transform_cloud(jnp.asarray(Tm), j)
        ot = ttf.transform_cloud(T(Tm), t)
        np.testing.assert_allclose(N(ot.xyz), np.asarray(oj.xyz), atol=1e-5)
        np.testing.assert_allclose(N(ot.attrs["normal"]), np.asarray(oj.attrs["normal"]),
                                   atol=1e-5)
        np.testing.assert_array_equal(N(ot.mask), np.asarray(oj.mask))

    @pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 2.0, np.pi - 1e-4])
    def test_so3_se3_exp_log(self, rng, scale):
        axis = rng.normal(size=(8, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        w = (axis * scale).astype(np.float32)
        xi = np.concatenate([rng.normal(size=(8, 3)), w], axis=1).astype(np.float32)
        # transcendentals in float32: agree to a few ulps of O(1) values
        np.testing.assert_allclose(N(ttf.hat(T(w))), np.asarray(jtf.hat(jnp.asarray(w))))
        Rj = np.asarray(jtf.so3_exp(jnp.asarray(w)))
        np.testing.assert_allclose(N(ttf.so3_exp(T(w))), Rj, atol=ATOL)
        np.testing.assert_allclose(N(ttf.so3_log(T(Rj))),
                                   np.asarray(jtf.so3_log(jnp.asarray(Rj))), atol=1e-4)
        Tj = np.asarray(jtf.se3_exp(jnp.asarray(xi)))
        np.testing.assert_allclose(N(ttf.se3_exp(T(xi))), Tj, atol=1e-5)
        np.testing.assert_allclose(N(ttf.se3_log(T(Tj))),
                                   np.asarray(jtf.se3_log(jnp.asarray(Tj))), atol=1e-4)
        np.testing.assert_allclose(N(ttf.rotation_angle(T(Rj))),
                                   np.asarray(jtf.rotation_angle(jnp.asarray(Rj))), atol=1e-4)

    def test_quaternions(self, rng):
        q = rng.normal(size=(16, 4)).astype(np.float32)
        q[0] = [0.0, 1.0, 0.0, 0.0]            # w = 0: the sign convention
        Rj = np.asarray(jtf.quat_to_matrix(jnp.asarray(q)))
        np.testing.assert_allclose(N(ttf.quat_to_matrix(T(q))), Rj, atol=ATOL)
        np.testing.assert_allclose(N(ttf.matrix_to_quat(T(Rj))),
                                   np.asarray(jtf.matrix_to_quat(jnp.asarray(Rj))), atol=ATOL)


# ---------------------------------------------------------------------------
# Geometry, morton keys, estimation
# ---------------------------------------------------------------------------

class TestGeometry:
    def test_means_and_covariance(self, rng):
        x = rng.normal(size=(3, 50, 3)).astype(np.float32)
        m = rng.uniform(size=(3, 50)) > 0.2
        w = rng.uniform(size=(3, 50)).astype(np.float32)
        np.testing.assert_allclose(N(tgeo.masked_mean(T(x[0]), T(m[0]))),
                                   np.asarray(jgeo.masked_mean(jnp.asarray(x[0]), jnp.asarray(m[0]))),
                                   atol=ATOL)
        np.testing.assert_allclose(N(tgeo.centroid(T(x), T(m))),
                                   np.asarray(jgeo.centroid(jnp.asarray(x), jnp.asarray(m))), atol=ATOL)
        for got, want in zip(tgeo.mean_and_covariance(T(x), T(m), T(w)),
                             jgeo.mean_and_covariance(jnp.asarray(x), jnp.asarray(m), jnp.asarray(w))):
            np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5)

    @pytest.mark.parametrize("axis", [0, 1])
    def test_masked_mean_takes_the_axis_by_name(self, rng, axis):
        """F7: ``axis=`` as in the JAX package, on a batched [B, N, 3] input,
        with a mask of the input's rank and with one along the axis alone."""
        x = rng.normal(size=(4, 50, 3)).astype(np.float32)
        masks = (rng.uniform(size=(4, 50, 1)) > 0.3, rng.uniform(size=x.shape[axis]) > 0.3)
        for m in masks:
            got = tgeo.masked_mean(T(x), T(m), axis=axis)
            want = jgeo.masked_mean(jnp.asarray(x), jnp.asarray(m), axis=axis)
            assert got.shape == want.shape
            np.testing.assert_allclose(N(got), np.asarray(want), atol=ATOL)

    def test_rotation_from_cross_covariance(self, rng):
        H = rng.normal(size=(6, 3, 3)).astype(np.float32)
        # same algorithm, same float32 steps: rotations agree to 1e-5
        np.testing.assert_allclose(
            N(tgeo.rotation_from_cross_covariance(T(H))),
            np.asarray(jgeo.rotation_from_cross_covariance(jnp.asarray(H))), atol=1e-5)

    @pytest.mark.parametrize("with_scale", [False, True])
    def test_umeyama(self, rng, with_scale):
        src = rng.normal(size=(200, 3)).astype(np.float32)
        Tm = _transforms(rng, 1)[0]
        s = 1.7 if with_scale else 1.0
        dst = (s * src @ Tm[:3, :3].T + Tm[:3, 3]
               + 0.01 * rng.normal(size=(200, 3))).astype(np.float32)
        w = (rng.uniform(size=200) > 0.1).astype(np.float32)
        got = N(tgeo.umeyama(T(src), T(dst), T(w), with_scale=with_scale))
        want = np.asarray(jgeo.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                                       with_scale=with_scale))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_morton_encode_bit_exact(self, rng):
        cell = rng.integers(0, 1024, size=(500, 3)).astype(np.int32)
        np.testing.assert_array_equal(N(tlinear.morton_encode(T(cell))),
                                      np.asarray(jlinear.morton_encode(jnp.asarray(cell))))

    @pytest.mark.parametrize("variant", ["point_to_plane", "symmetric"])
    def test_plane_estimators(self, rng, variant):
        src = rng.normal(size=(300, 3)).astype(np.float32)
        dst = (src + 0.02 * rng.normal(size=(300, 3))).astype(np.float32)
        n = rng.normal(size=(300, 3))
        n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
        w = (rng.uniform(size=300) > 0.2).astype(np.float32)
        if variant == "point_to_plane":
            for got, want in zip(
                    test_.point_to_plane_system(T(src), T(dst), T(n), T(w)),
                    jest.point_to_plane_system(*map(jnp.asarray, (src, dst, n, w)))):
                np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-4)
            got = test_.estimate_point_to_plane(T(src), T(dst), T(n), T(w))
            want = jest.estimate_point_to_plane(*map(jnp.asarray, (src, dst, n, w)))
        else:
            got = test_.estimate_symmetric_point_to_plane(T(src), T(n), T(dst), T(n), T(w))
            want = jest.estimate_symmetric_point_to_plane(
                *map(jnp.asarray, (src, n, dst, n, w)))
        # a 6x6 solve of a well-conditioned system: increments agree to 1e-5
        np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(N(test_.estimate_svd(T(src), T(dst), T(w))),
                                   np.asarray(jest.estimate_svd(*map(jnp.asarray, (src, dst, w)))),
                                   atol=1e-5)
