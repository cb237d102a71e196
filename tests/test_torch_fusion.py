"""Parity of pcl_tpu_torch.fusion (TSDF, KinFu, world model) and
filters.convolution.fast_bilateral with the JAX package on the CPU, on the
scenes of ``tests/test_fusion.py``: 96^3 volumes, 60 x 80 frames.

Tolerances, stated where each is checked:

- ``fast_bilateral``: 1e-5 m (measured 6e-7: the splat adds in the same
  order, the blur and the slice round alike but for XLA's fused products);
- ``integrate``: weights equal and TSDF within 1e-5, except voxels whose
  projection lies within 1e-4 pixel of a half pixel (``round`` may take the
  neighbouring pixel when ``inv(pose)`` differs by an ulp) or whose ``sdf``
  lies within 1e-6 m of ``-trunc``; those are counted (at most 0.5% of the
  voxels) and left out (measured: none);
- ``raycast``: hit masks equal except pixels whose ray samples a TSDF value
  within 1e-5 of zero (counted; measured: none); vertices within 1e-4 m;
  normals ``n . n' >= 1 - 1e-4``;
- ``extract_surface_points``, ``depth_to_vertex_map``: exact;
  ``vertex_map_normals`` within 1e-6;
- ``kinfu_step`` over five frames, with a lost frame and a reset: poses within
  1e-4, ``lost`` and ``frame`` equal, a lost frame leaves the volume as it
  was;
- ``save_tsdf``/``load_tsdf`` and ``WorldModel.save``/``load``: a file
  written by one package is read by the other, arrays equal.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_fusion as jfus
from pcl_tpu.filters.convolution import fast_bilateral as j_bilateral
from pcl_tpu.fusion import kinfu as jk
from pcl_tpu.fusion import tsdf as jt
from pcl_tpu.fusion import world_model as jw

from pcl_tpu_torch import interop
from pcl_tpu_torch.filters import fast_bilateral as t_bilateral
from pcl_tpu_torch.fusion import kinfu as tk
from pcl_tpu_torch.fusion import tsdf as tt
from pcl_tpu_torch.fusion import world_model as tw

H, W = jfus.H, jfus.W
J_INTR, T_INTR = jt.Intrinsics(*jfus.INTR), tt.Intrinsics(*jfus.INTR)
ORIGIN = (-1.5, -1.5, 0.0)


def _volumes(resolution=96, size=3.0, origin=ORIGIN):
    return (jt.make_volume(resolution, size, origin=jnp.asarray(origin)),
            tt.make_volume(resolution, size, origin=origin, device="cpu"))


def _frames(n=4, dyaw=0.05):
    """The rough wall of ``test_fusion.TestKinfuPyramid`` seen along a yaw."""
    poses, depths = jfus.TestKinfuPyramid()._yaw_sequence(dyaw, n_frames=n - 1)
    return [p.astype(np.float32) for p in poses], depths


def _holes(depth, rng, share=0.05):
    d = depth.copy()
    d[rng.random(d.shape) < share] = 0.0
    return d


def test_make_volume_matches_jax():
    jv, tv = _volumes(32, 2.0, (0.1, -0.2, 0.3))
    for name in ("tsdf", "weight", "origin", "voxel_size", "trunc"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(), np.asarray(getattr(jv, name)))
    assert tv.resolution == jv.resolution == 32
    assert tt.make_volume(8, 1.0, trunc=0.05, device="cpu").trunc.item() == np.float32(0.05)


@pytest.mark.parametrize("kw", [{}, dict(sigma_s=3.0, sigma_r=0.02, grid_xy=32, grid_z=16)])
def test_fast_bilateral_matches_jax(rng, kw):
    _, depths = _frames(1)
    d = _holes(depths[0] + rng.normal(scale=0.003, size=depths[0].shape).astype(np.float32), rng)
    j = np.asarray(j_bilateral(jnp.asarray(d), **kw))
    t = t_bilateral(torch.from_numpy(d), **kw).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)              # metres
    np.testing.assert_array_equal(t[d <= 0], d[d <= 0])


def _boundary_voxels(vol, depth, pose):
    """Voxels whose pixel or update test lies within rounding of its edge:
    the projection within 1e-4 pixel of a half pixel, or ``sdf`` within 1e-6
    m of ``-trunc`` (float64)."""
    R = vol.resolution
    c = (np.arange(R) + 0.5) * float(vol.voxel_size)
    o = np.asarray(vol.origin, np.float64)
    g = np.stack(np.meshgrid(c + o[0], c + o[1], c + o[2], indexing="ij"), -1)
    w2c = np.linalg.inv(np.asarray(pose, np.float64))
    cam = g @ w2c[:3, :3].T + w2c[:3, 3]
    z = np.maximum(cam[..., 2], 1e-9)
    u = J_INTR.fx * cam[..., 0] / z + J_INTR.cx
    v = J_INTR.fy * cam[..., 1] / z + J_INTR.cy
    half = (np.abs(u - np.floor(u) - 0.5) < 1e-4) | (np.abs(v - np.floor(v) - 0.5) < 1e-4)
    ui = np.clip(np.round(u), 0, W - 1).astype(int)
    vi = np.clip(np.round(v), 0, H - 1).astype(int)
    sdf = depth[vi, ui] - cam[..., 2]
    return half | (np.abs(sdf + float(vol.trunc)) < 1e-6)


def test_integrate_matches_jax(rng):
    poses, depths = _frames(3)
    jv, tv = _volumes()
    near = np.zeros((96,) * 3, bool)
    for P, d in zip(poses, depths):
        d = _holes(d, rng, 0.02)
        near |= _boundary_voxels(jv, d, P)
        jv = jt.integrate(jv, jnp.asarray(d), J_INTR, jnp.asarray(P))
        tv = tt.integrate(tv, torch.from_numpy(d), T_INTR, torch.from_numpy(P))
    jw_, jt_ = np.asarray(jv.weight), np.asarray(jv.tsdf)
    differ = (tv.weight.numpy() != jw_) | (np.abs(tv.tsdf.numpy() - jt_) > 1e-5)
    assert near.mean() <= 0.005, near.mean()
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    assert jw_.max() == 3 and (jw_ > 0).mean() > 0.05          # the frames were fused


def test_integrate_in_slabs_equals_one_pass(monkeypatch, rng):
    """The slab loop gives the volume of one pass over all voxels."""
    poses, depths = _frames(2)
    _, tv = _volumes(40, 3.0)
    one = tt.integrate(tv, torch.from_numpy(depths[1]), T_INTR, torch.from_numpy(poses[1]))
    monkeypatch.setattr(tt, "_SLAB_VOXELS", 3 * 40 * 40)       # 3 x-planes a slab, ragged tail
    slabs = tt.integrate(tv, torch.from_numpy(depths[1]), T_INTR, torch.from_numpy(poses[1]))
    assert torch.equal(one.tsdf, slabs.tsdf) and torch.equal(one.weight, slabs.weight)


def test_integrate_maps_points_behind_and_at_the_camera_outside():
    """Voxels at z ~ 0 have huge projections; the clamp before the cast keeps
    them outside the frame (no wrapped int32 index)."""
    _, tv = _volumes(24, 2.0, (-1.0, -1.0, -1.0))
    d = torch.full((H, W), 0.5)
    out = tt.integrate(tv, d, T_INTR, torch.eye(4))
    jv = jt.make_volume(24, 2.0, origin=jnp.asarray([-1.0, -1.0, -1.0]))
    ref = jt.integrate(jv, jnp.asarray(d.numpy()), J_INTR, jnp.eye(4))
    np.testing.assert_array_equal(out.weight.numpy(), np.asarray(ref.weight))
    assert tt._pixel(torch.tensor([-1e12, -0.5, 0.5, 79.5, 1e12]), W).tolist() == [-1, 0, 0, 80, 80]


def _fused_pair(n=3):
    poses, depths = _frames(n)
    jv, tv = _volumes()
    for P, d in zip(poses, depths):
        jv = jt.integrate(jv, jnp.asarray(d), J_INTR, jnp.asarray(P))
        tv = tt.integrate(tv, torch.from_numpy(d), T_INTR, torch.from_numpy(P))
    return poses, jv, tv


def _zero_sample_pixels(vol, P, pixels, near=0.1, far=5.0, n_steps=256):
    """For each (row, col), whether its ray samples a TSDF value within 1e-5
    of zero (float64 march over the JAX volume)."""
    tsdf = np.asarray(vol.tsdf, np.float64)
    R, vs, o = vol.resolution, float(vol.voxel_size), np.asarray(vol.origin, np.float64)
    out = []
    for r, c in pixels:
        d = np.array([(c + 0.5 - J_INTR.cx) / J_INTR.fx, (r + 0.5 - J_INTR.cy) / J_INTR.fy, 1.0])
        d = P[:3, :3] @ (d / np.linalg.norm(d))
        vals = []
        for i in range(n_steps):
            g = (P[:3, 3] + (near + i * (far - near) / n_steps) * d - o) / vs - 0.5
            g0 = np.floor(g).astype(int)
            if (g0 < 0).any() or (g0 >= R - 1).any():
                continue
            f = g - g0
            cube = tsdf[g0[0]:g0[0] + 2, g0[1]:g0[1] + 2, g0[2]:g0[2] + 2]
            wx, wy, wz = (np.array([1 - f[a], f[a]]) for a in range(3))
            vals.append(np.einsum("ijk,i,j,k->", cube, wx, wy, wz))
        out.append(bool(vals) and np.min(np.abs(vals)) < 1e-5)
    return np.array(out, bool)


@pytest.mark.parametrize("frame", [0, 2])
def test_raycast_matches_jax(frame):
    poses, jv, tv = _fused_pair()
    P = poses[frame]
    jv_, jn_, jh_ = (np.asarray(a) for a in jt.raycast(jv, J_INTR, jnp.asarray(P), H, W))
    tv_, tn_, th_ = (a.numpy() for a in tt.raycast(tv, T_INTR, torch.from_numpy(P), H, W))
    flips = np.argwhere(jh_ != th_)
    assert len(flips) <= 0.005 * H * W
    assert _zero_sample_pixels(jv, P.astype(np.float64), flips).all()
    both = jh_ & th_
    assert both.mean() > 0.9
    np.testing.assert_allclose(tv_[both], jv_[both], atol=1e-4)        # metres
    assert (np.sum(tn_ * jn_, -1)[both] >= 1 - 1e-4).all()
    assert (tv_[~th_] == 0).all() and (tn_[~th_] == 0).all()


def test_raycast_march_in_chunks_equals_single_steps(monkeypatch):
    poses, _, tv = _fused_pair(2)
    P = torch.from_numpy(poses[1])
    chunked = tt.raycast(tv, T_INTR, P, H, W, n_steps=200)
    monkeypatch.setattr(tt, "_MARCH_STEPS", 1)
    single = tt.raycast(tv, T_INTR, P, H, W, n_steps=200)
    for a, b in zip(chunked, single):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_points", [1 << 18, 500])
def test_extract_surface_points_matches_jax(max_points):
    _, jv, tv = _fused_pair(2)
    jp, jvld = jt.extract_surface_points(jv, max_points=max_points)
    tp, tvld = tt.extract_surface_points(tv, max_points=max_points)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tvld.numpy(), np.asarray(jvld))
    assert 0 < int(tvld.sum()) <= max_points


def test_vertex_and_normal_maps_match_jax(rng):
    _, depths = _frames(2)
    d = _holes(depths[1], rng)
    jv = jt.depth_to_vertex_map(jnp.asarray(d), J_INTR)
    tv = tt.depth_to_vertex_map(torch.from_numpy(d), T_INTR)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tt.vertex_map_normals(tv).numpy(),
                               np.asarray(jt.vertex_map_normals(jv)), atol=1e-6)


def test_pyramid_levels_match_jax(rng):
    poses, jv, _ = _fused_pair(2)
    maps = [np.array(a) for a in jt.raycast(jv, J_INTR, jnp.asarray(poses[1]), H, W)]
    for a, b in zip(jk._pyr_down_map(*map(jnp.asarray, maps)),
                    tk._pyr_down_map(*map(torch.from_numpy, maps))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    d = _holes(_frames(1)[1][0], rng)
    d[:, :7] += 0.3                                               # a depth edge
    np.testing.assert_allclose(tk._pyr_down_depth(torch.from_numpy(d[:-1, :-1])).numpy(),
                               np.asarray(jk._pyr_down_depth(jnp.asarray(d[:-1, :-1]))), atol=1e-6)
    assert tk._scale_intrinsics(T_INTR, 2) == tuple(float(x) for x in
                                                     jk._scale_intrinsics(J_INTR, 2))


def _kinfu_pair(depths, steps_kw=None, **kw):
    """Both trackers over ``depths``; returns the lists of states."""
    jv, tv = _volumes(96, 3.2, (-1.6, -1.6, 0.0))
    js, ts = [jk.kinfu_init(jv, H, W)], [tk.kinfu_init(tv, H, W)]
    for d in depths:
        js.append(jk.kinfu_step(js[-1], jnp.asarray(d), J_INTR, **kw))
        ts.append(tk.kinfu_step(ts[-1], torch.from_numpy(d), T_INTR, **kw))
    return js[1:], ts[1:]


def _same_state(j, t):
    np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), atol=1e-4)
    assert bool(t.lost) == bool(j.lost) and int(t.frame) == int(j.frame)


def test_kinfu_step_matches_jax_with_a_lost_frame_and_reset():
    """Five frames of test_fusion's lost-frame case: two tracked frames, a
    garbage frame (lost, not integrated), then a reset and two more."""
    _, depths = jfus.TestKinfuPyramid()._yaw_sequence(0.02, n_frames=3)
    garbage = np.full((H, W), 4.5, np.float32)
    js, ts = _kinfu_pair([depths[0], depths[1], garbage])
    for j, t in zip(js, ts):
        _same_state(j, t)
    assert [bool(t.lost) for t in ts] == [False, False, True]
    assert torch.equal(ts[2].volume.tsdf, ts[1].volume.tsdf)
    assert torch.equal(ts[2].volume.weight, ts[1].volume.weight)
    jv, tv = _volumes(96, 3.2, (-1.6, -1.6, 0.0))
    j, t = jk.kinfu_reset(js[-1], jv), tk.kinfu_reset(ts[-1], tv)
    _same_state(j, t)
    for d in depths[2:4]:
        j = jk.kinfu_step(j, jnp.asarray(d), J_INTR)
        t = tk.kinfu_step(t, torch.from_numpy(d), T_INTR)
        _same_state(j, t)


@pytest.mark.parametrize("levels,bilateral", [(3, True), (1, False)])
def test_kinfu_step_tracks_as_jax(levels, bilateral):
    """The pyramid test's yaw sequence: the same poses frame by frame."""
    poses, depths = _frames(5, dyaw=0.03)
    js, ts = _kinfu_pair(depths, levels=levels, bilateral=bilateral, dist_thresh=0.3)
    for j, t in zip(js, ts):
        _same_state(j, t)
        np.testing.assert_allclose(t.prev_verts.numpy(), np.asarray(j.prev_verts), atol=1e-4)
    assert np.abs(ts[-1].pose.numpy()[:3, 3] - poses[-1][:3, 3]).max() < 0.01


def test_kinfu_state_carries_over_from_jax():
    """A JAX tracker's state, converted, tracks on as the JAX tracker does."""
    _, depths = _frames(4, dyaw=0.03)
    jv = jt.make_volume(96, 3.0, origin=jnp.asarray(ORIGIN))
    j = jk.kinfu_init(jv, H, W)
    for d in depths[:3]:
        j = jk.kinfu_step(j, jnp.asarray(d), J_INTR)
    vol = interop.tsdf_volume_from_arrays(*(np.asarray(a) for a in (
        j.volume.tsdf, j.volume.weight, j.volume.origin, j.volume.voxel_size, j.volume.trunc)),
        device="cpu")
    t = interop.kinfu_state_from_arrays(vol, *(np.asarray(a) for a in (
        j.pose, j.prev_verts, j.prev_normals, j.prev_hit, j.frame, j.lost)), device="cpu")
    assert t.frame.dtype == torch.int32 and int(t.frame) == 3 and t.prev_hit.dtype == torch.bool
    j = jk.kinfu_step(j, jnp.asarray(depths[3]), J_INTR)
    t = tk.kinfu_step(t, torch.from_numpy(depths[3]), T_INTR)
    _same_state(j, t)
    with pytest.raises(ValueError, match="R, R, R"):
        interop.tsdf_volume_from_arrays(np.zeros((4, 4, 5)), np.zeros((4, 4, 5)), np.zeros(3),
                                        0.1, 0.3, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tsdf_files_cross_packages(tmp_path, writer):
    _, jv, tv = _fused_pair(2)
    path = str(tmp_path / "vol.npz")
    if writer == "jax":
        jw.save_tsdf(path, jv)
        back = tw.load_tsdf(path, device="cpu")
        ref = jv
    else:
        tw.save_tsdf(path, tv)
        back = jw.load_tsdf(path)
        ref = tv
    for name in ("tsdf", "weight", "origin", "voxel_size", "trunc"):
        a, b = getattr(back, name), getattr(ref, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_world_model_crosses_packages(tmp_path, rng, writer):
    slabs = [(0.6, rng.uniform(-1, 1, (4, 6, 5)), rng.integers(0, 3, (4, 6, 5))),
             (0.9, rng.uniform(-1, 1, (4, 6, 5)), rng.integers(0, 3, (4, 6, 5))),
             (0.6, rng.uniform(-1, 1, (4, 6, 5)), rng.integers(0, 3, (4, 6, 5)))]   # merged
    models = (jw.WorldModel(0.1, (0.2, 0.0, 0.0)), tw.WorldModel(0.1, (0.2, 0.0, 0.0)))
    for x, t, w in slabs:
        models[0].push_slab(x, t.astype(np.float32), w.astype(np.float32))
        models[1].push_slab(x, torch.from_numpy(t.astype(np.float32)),
                            torch.from_numpy(w.astype(np.float32)))
    np.testing.assert_array_equal(models[1].extract_points(), models[0].extract_points())
    path = str(tmp_path / "world.npz")
    (models[0] if writer == "jax" else models[1]).save(path)
    back = (tw if writer == "jax" else jw).WorldModel.load(path)
    assert back.n_slabs == 2
    for x in (0.6, 0.9, 1.5):
        for a, b in zip(back.fetch_slab(x, (4, 6, 5)), models[0].fetch_slab(x, (4, 6, 5))):
            np.testing.assert_array_equal(a, b)


def test_fusion_exported_under_jax_names():
    tf_ = importlib.import_module("pcl_tpu_torch.fusion")
    jf_ = importlib.import_module("pcl_tpu.fusion")
    for name in ("TSDFVolume", "make_volume", "integrate", "raycast", "extract_surface_points",
                 "depth_to_vertex_map", "vertex_map_normals", "KinfuState", "kinfu_init",
                 "kinfu_step", "kinfu_reset", "WorldModel", "save_tsdf", "load_tsdf"):
        assert hasattr(tf_, name) and hasattr(jf_, name), name
    assert tk.LEVEL_ITERS == jk.LEVEL_ITERS
