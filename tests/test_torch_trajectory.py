"""Parity of pcl_tpu_torch.registration.trajectory with
pcl_tpu.registration.trajectory on the CPU, and the slice as a whole: scans
-> voxel_downsample -> estimate_normals -> point-to-plane odometry_sequence
-> trajectory_ate, through both packages.

The metrics and fixtures are the same numpy code on both sides: equal to
float64 rounding (1e-12). The whole-slice run compares poses, not iteration
counts: the port's 1-NN returns exact distances where the JAX package's CPU
path returns the matmul identity (ROADMAP C1), which moves the iteration at
which the MSE tests fire but not the fixed point; poses agree within 1e-4 m
and 1e-4 in rotation entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import features as jfeat
from pcl_tpu import filters as jfilt
from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.registration import trajectory as jtraj

from pcl_tpu_torch import features as tfeat
from pcl_tpu_torch import filters as tfilt
from pcl_tpu_torch.core.cloud import make_cloud as tmake
from pcl_tpu_torch.registration import trajectory as ttraj


def _walk(rng, m=6, noise=0.0):
    """A golden trajectory and a perturbed estimate of it."""
    scene = rng.uniform(-1, 1, size=(50, 3))
    _, golden = jtraj.make_drift_sequence(scene, m, np.random.default_rng(3),
                                          step_translation=0.3, step_rotation=0.1)
    est = golden.copy()
    est[:, :3, 3] += rng.normal(scale=0.02, size=(m, 3)) + noise
    return est, golden


@pytest.mark.parametrize("align", [True, False])
def test_trajectory_ate(rng, align):
    est, golden = _walk(rng, noise=0.5)
    want = jtraj.trajectory_ate(est, golden, align=align)
    got = ttraj.trajectory_ate(est, golden, align=align)
    for f in ("rmse", "mean", "median", "max"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(got.errors, want.errors, atol=1e-12)
    np.testing.assert_allclose(got.alignment, want.alignment, atol=1e-12)
    with pytest.raises(ValueError):
        ttraj.trajectory_ate(est[:3], golden)


def test_trajectory_rpe_and_umeyama(rng):
    est, golden = _walk(rng)
    for delta in (1, 2):
        want = jtraj.trajectory_rpe(est, golden, delta=delta)
        got = ttraj.trajectory_rpe(est, golden, delta=delta)
        assert got.trans_rmse == pytest.approx(want.trans_rmse, rel=1e-12)
        assert got.rot_rmse == pytest.approx(want.rot_rmse, rel=1e-12, abs=1e-12)
    src = rng.normal(size=(20, 3))
    dst = src @ golden[3, :3, :3].T + golden[3, :3, 3]
    np.testing.assert_allclose(ttraj.umeyama_se3(src, dst), jtraj.umeyama_se3(src, dst),
                               atol=1e-12)
    np.testing.assert_allclose(ttraj.umeyama_se3(src, dst), golden[3], atol=1e-9)


@pytest.mark.parametrize("fixture", ["virtual_scan", "drift"])
def test_sequence_fixtures_equal(fixture):
    scene = np.random.default_rng(0).uniform(-3, 3, size=(4000, 3)) + [0, 0, 4]
    kw = dict(n_scans=4, step_translation=0.1, noise=0.003)
    if fixture == "virtual_scan":
        want = jtraj.make_virtual_scan_sequence(scene, rng=np.random.default_rng(5),
                                                max_points=900, **kw)
        got = ttraj.make_virtual_scan_sequence(scene, rng=np.random.default_rng(5),
                                               max_points=900, **kw)
    else:
        want = jtraj.make_drift_sequence(scene, rng=np.random.default_rng(5), **kw)
        got = ttraj.make_drift_sequence(scene, rng=np.random.default_rng(5), **kw)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], want[1])


def test_odometry_sequence_custom_register():
    """A register callable that returns a known transform: poses chain as
    abs_k = abs_{k-1} @ T, on a CUDA-less tensor result as on an array."""
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.05]

    class Res:
        def __init__(self, t):
            self.transform = t

    clouds = [tmake(np.zeros((4, 3)), device="cpu")] * 3
    got = ttraj.odometry_sequence(clouds, register=lambda s, t: Res(torch.tensor(T)))
    want = jtraj.odometry_sequence(clouds, register=lambda s, t: Res(T))
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(got[2, :3, 3], [0.2, -0.4, 0.1], atol=1e-12)
    inits = [np.eye(4)] * 2
    seen = []
    ttraj.odometry_sequence(clouds, register=lambda s, t, init: seen.append(init) or Res(T),
                            init_deltas=inits)
    assert len(seen) == 2


def _room(rng, n=24000):
    """Floor, three walls and a box, by area: structure on every axis."""
    parts = [
        (np.array([-3, -1, 0.0]), np.array([6.0, 0, 0]), np.array([0, 0, 8.0])),    # floor
        (np.array([-3, -1, 8.0]), np.array([6.0, 0, 0]), np.array([0, 3.0, 0])),    # far wall
        (np.array([-3, -1, 0.0]), np.array([0, 3.0, 0]), np.array([0, 0, 8.0])),    # left
        (np.array([3, -1, 0.0]), np.array([0, 3.0, 0]), np.array([0, 0, 8.0])),     # right
        (np.array([0.5, -1, 3.0]), np.array([1.0, 0, 0]), np.array([0, 1.0, 0])),   # box front
        (np.array([0.5, -1, 3.0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0])),   # box side
        (np.array([0.5, 0, 3.0]), np.array([1.0, 0, 0]), np.array([0, 0, 1.0])),    # box top
    ]
    area = np.array([np.linalg.norm(np.cross(a, b)) for _, a, b in parts])
    k = rng.choice(len(parts), size=n, p=area / area.sum())
    uv = rng.random((n, 2))
    o = np.stack([parts[i][0] for i in k])
    a = np.stack([parts[i][1] for i in k])
    b = np.stack([parts[i][2] for i in k])
    return o + uv[:, :1] * a + uv[:, 1:] * b


def test_slice_odometry_matches_jax():
    """Three scans through the whole front end on both packages."""
    rng = np.random.default_rng(11)
    scans, golden = ttraj.make_virtual_scan_sequence(
        _room(rng), 3, np.random.default_rng(12), step_translation=0.05,
        step_rotation=0.02, fov_tan=1.2, z_range=(0.3, 8.0), max_points=3000,
        noise=0.002)
    cap = 3000
    icp_kw = dict(variant="point_to_plane", max_corr_dist=0.1, max_iterations=40)
    jclouds, tclouds = [], []
    for s in scans:
        jc = jfilt.voxel_downsample(jmake(jnp.asarray(s), capacity=cap), 0.15)
        jclouds.append(jfeat.estimate_normals(jc, k=12))
        tc = tfilt.voxel_downsample(tmake(s, capacity=cap, device="cpu"), 0.15)
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
        tclouds.append(tfeat.estimate_normals(tc, k=12))
    want = jtraj.odometry_sequence(jclouds, **icp_kw)
    got = ttraj.odometry_sequence(tclouds, **icp_kw)
    assert got.dtype == np.float64 and got.shape == (3, 4, 4)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=1e-4)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-4)
    ate_j = jtraj.trajectory_ate(want, golden, align=False)
    ate_t = ttraj.trajectory_ate(got, golden, align=False)
    assert ate_t.rmse == pytest.approx(ate_j.rmse, abs=1e-4)
    assert ate_t.rmse < 5e-3            # the front end recovers the walk
