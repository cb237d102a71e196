"""F8: float-to-int casts of cell and bin coordinates beyond the int32 range.

XLA's float32-to-int32 cast saturates and takes NaN to 0; torch's gives
INT_MIN on the CPU (ROADMAP C71). Every ``floor(...)`` cast to an int in the
port goes through ``core.casts.xla_int32``. These tests hold the functions a
finite input can push past the range to the JAX package at x = +3e9, -3e9
and 1e20 m (one valid point among 64 in [-5, 5] m), and the fast bilateral
grid at a NaN depth. The JAX package merges the far point's voxel with
another at +3e9 and 1e20 m (both land on the top cell): a trait of the
reference that the port copies. Within range ``xla_int32`` of a floored
value equals the plain cast, so the other parity tests are unmoved.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import filters as jf
from pcl_tpu import search as js
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.filters import convolution as jconv

from pcl_tpu_torch import filters as tf
from pcl_tpu_torch import search as ts
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.filters import convolution as tconv

jndt = importlib.import_module("pcl_tpu.registration.ndt")
jndt2d = importlib.import_module("pcl_tpu.registration.ndt2d")
tndt = importlib.import_module("pcl_tpu_torch.registration.ndt")
tndt2d = importlib.import_module("pcl_tpu_torch.registration.ndt2d")

FAR = [3e9, -3e9, 1e20]
# voxels of voxel_downsample at a 0.5 m leaf, the same in both packages; the
# 64 near points alone give 63, and +3e9 and 1e20 m merge the far point with
# a near voxel
VOXELS = {3e9: 62, -3e9: 63, 1e20: 62}


def _scene(far):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-5, 5, (65, 3)).astype(np.float32)
    xyz[64] = [far, 0.0, 0.0]
    mask = np.ones(65, bool)
    jc = JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask))
    tc = Cloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask))
    return jc, tc


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("far", FAR)
def test_voxel_grids_cast_as_xla(far):
    jc, tc = _scene(far)
    got, want = tf.voxel_downsample(tc, 0.5), jf.voxel_downsample(jc, 0.5)
    _eq(got.mask, want.mask)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=1e-6, atol=1e-5)
    assert int(got.mask.sum()) == VOXELS[far]
    got, want = tf.approximate_voxel_grid(tc, 0.5), jf.approximate_voxel_grid(jc, 0.5)
    _eq(got.mask, want.mask)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=1e-6, atol=1e-5)
    for res in (0.5, 2.0):
        _eq(tf.grid_minimum(tc, res).mask, jf.grid_minimum(jc, res).mask)


@pytest.mark.parametrize("far", FAR)
def test_morphological_filters_cast_as_xla(far):
    jc, tc = _scene(far)
    for op in ("open", "dilate"):
        _eq(tf.morphological_filter(tc, 1.0, operator=op, grid=64),
            jf.morphological_filter(jc, 1.0, operator=op, grid=64))
    _eq(tf.progressive_morphological_filter(tc, grid=64),
        jf.progressive_morphological_filter(jc, grid=64))


@pytest.mark.parametrize("far", FAR)
def test_cell_searches_and_ndt_grids_cast_as_xla(far):
    """The cell list's cells, the NDT grids' owner keys (3-D and 2-D), and
    queries far out; padding slots of k-NN are not compared (each package
    fills them its own way)."""
    jc, tc = _scene(far)
    q = np.array([[far, 0, 0], [0, far, 0], [far, -far, far], [1, 1, 1]], np.float32)
    for qj, qt in ((jc.xyz, tc.xyz), (jnp.asarray(q), torch.from_numpy(q))):
        ti, td, tv = ts.knn(tc, qt, 4, backend="cell", cell_size=1.0)
        ji, jd, jv = js.knn(jc, qj, 4, backend="cell", cell_size=1.0)
        _eq(tv, jv)
        v = tv.numpy()
        np.testing.assert_array_equal(ti.numpy()[v], np.asarray(ji)[v])
    tg = tndt.build_grid(tc.xyz, tc.mask, 2.0, min_points=2)
    jg = jndt.build_grid(jc.xyz, jc.mask, 2.0, min_points=2)
    for k in ("valid", "ckey1", "ckey2"):
        _eq(getattr(tg, k), getattr(jg, k))
    tg = tndt2d.build_grid_2d(tc.xyz[:, :2], tc.mask, 2.0)
    jg = jndt2d.build_grid_2d(jc.xyz[:, :2], jc.mask, 2.0)
    for k in ("valid", "ckey"):
        _eq(getattr(tg, k), getattr(jg, k))


def test_fast_bilateral_takes_a_nan_depth_as_jax():
    """A NaN pixel (an organized PCD's missing return) lands in grid cell 0
    in both packages; before F8 the port indexed with INT64_MIN and raised."""
    rng = np.random.default_rng(1)
    z = (1 + rng.random((24, 32))).astype(np.float32)
    z[3, 4], z[5, 6] = np.nan, 0.0
    got = tconv.fast_bilateral(torch.from_numpy(z), sigma_s=4.0, sigma_r=0.1)
    want = jconv.fast_bilateral(jnp.asarray(z), sigma_s=4.0, sigma_r=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5,
                               equal_nan=True)
