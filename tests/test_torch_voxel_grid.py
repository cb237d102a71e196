"""Parity of pcl_tpu_torch.filters.voxel_grid with pcl_tpu.filters.voxel_grid
on the CPU.

- ``voxel_downsample`` (one cell sort and one segment sum, the plain version
  of kernel B2 on CPU tensors) against the JAX package's CPU scatter path:
  both add each voxel's points in original point order, so means agree to
  float32 rounding of the division (1e-6 of the coordinate scale); masks,
  voxel order and counts exactly.
- The same against ``_voxel_downsample_tpu`` with the Pallas kernel
  interpreted, as ``tests/test_pallas_segsum.py`` runs it: the sums are taken
  in other orders (a one-hot product there), so means of a few points agree
  to 1e-5 of their scale. Both bounding-box regimes go through the one
  segment sum.
- ``uniform_sample`` keeps input points: equal exactly (inputs without
  duplicated points, so no exact distance ties).
"""
import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.filters import voxel_grid as jvg
from pcl_tpu.ops import pallas_segsum

from pcl_tpu_torch import filters
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.filters import voxel_grid as tvg
from pcl_tpu_torch.ops import segsum


def _cloud(rng, n=4000, extent=1.0, attrs=("normal", "intensity", "label")):
    xyz = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.85
    xyz[~mask] = 0.0
    a = {}
    if "normal" in attrs:
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        a["normal"] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    if "intensity" in attrs:
        a["intensity"] = rng.random(n).astype(np.float32)
    if "label" in attrs:
        a["label"] = rng.integers(0, 5, n).astype(np.int32)
    for v in a.values():
        v[~mask] = 0
    jc = JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask),
                attrs={k: jnp.asarray(v) for k, v in a.items()})
    tc = Cloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask),
               attrs={k: torch.from_numpy(v) for k, v in a.items()})
    return jc, tc


def _same_cloud(got, want, atol):
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=0, atol=atol)
    assert set(got.attrs) == set(want.attrs)
    for k, v in want.attrs.items():
        g = got.attrs[k]
        assert g.numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=0, atol=atol, err_msg=k)


LEAVES = [("scalar", 0.1), ("per_axis", np.float32([0.1, 0.25, 0.05]))]


@pytest.mark.parametrize("average_attrs", [True, False])
@pytest.mark.parametrize("name,leaf", LEAVES, ids=[x[0] for x in LEAVES])
def test_voxel_downsample_cpu_path(rng, name, leaf, average_attrs):
    jc, tc = _cloud(rng)
    want = jvg.voxel_downsample(jc, leaf, average_attrs=average_attrs)
    got = filters.voxel_downsample(tc, leaf, average_attrs=average_attrs)
    _same_cloud(got, want, atol=1e-6)
    assert int(got.mask.sum()) > 500
    if not average_attrs:
        assert got.attrs == {}


def _interpreted_segsum(monkeypatch):
    orig = pallas_segsum.segment_sum_sorted

    def interp(vals, seg, chunk=512, interpret=False):
        return orig(vals, seg, chunk=chunk, interpret=True)

    monkeypatch.setattr(pallas_segsum, "segment_sum_sorted", interp)


def _counted_segsum(monkeypatch):
    """Record each call of the port's segment sum (the kernel's wrapper)."""
    calls = []
    orig = segsum.segment_sum_sorted

    def counted(vals, seg):
        calls.append(tuple(vals.shape))
        return orig(vals, seg)

    monkeypatch.setattr(segsum, "segment_sum_sorted", counted)
    return calls


@pytest.mark.parametrize("name,leaf", LEAVES, ids=[x[0] for x in LEAVES])
def test_voxel_downsample_segsum_path(rng, monkeypatch, name, leaf):
    jc, tc = _cloud(rng)
    _interpreted_segsum(monkeypatch)
    calls = _counted_segsum(monkeypatch)
    items_j = sorted(jc.attrs.items())
    want = jvg._voxel_downsample_tpu(jc, leaf, items_j)
    got = filters.voxel_downsample(tc, leaf)
    # one sum of xyz, normal (3), intensity, label and the weight column
    assert calls == [(tc.capacity, 3 + 3 + 1 + 1 + 1)]
    _same_cloud(got, want, atol=1e-5)
    # and the same as the scatter path, on both sides
    _same_cloud(got, jvg.voxel_downsample(jc, leaf), atol=1e-5)


def test_voxel_downsample_segsum_path_no_attrs(rng, monkeypatch):
    jc, tc = _cloud(rng, attrs=())
    _interpreted_segsum(monkeypatch)
    calls = _counted_segsum(monkeypatch)
    want = jvg._voxel_downsample_tpu(jc, 0.2, [])
    got = filters.voxel_downsample(tc, 0.2)
    assert calls == [(tc.capacity, 4)]
    _same_cloud(got, want, atol=1e-5)


@pytest.mark.parametrize("path", ["scatter", "segsum"])
def test_lexicographic_branch_past_2_30_cells(rng, monkeypatch, path):
    """A 4 km box at a 1 mm leaf holds ~6e19 cells: the dense id would wrap,
    so both packages sort the three cell keys instead, and the port still
    takes the one segment sum."""
    jc, tc = _cloud(rng, n=3000, extent=2000.0, attrs=("intensity",))
    leaf = 0.001
    _, _, span = tvg.segsum.cell_grid(tc.xyz, tc.mask, leaf)
    assert float(tvg._n_cells(span)) >= 2 ** 30
    calls = _counted_segsum(monkeypatch)
    if path == "scatter":
        want = jvg.voxel_downsample(jc, leaf)
    else:
        _interpreted_segsum(monkeypatch)
        want = jvg._voxel_downsample_tpu(jc, leaf, sorted(jc.attrs.items()))
    got = filters.voxel_downsample(tc, leaf)
    assert calls == [(tc.capacity, 3 + 1 + 1)]
    # every valid point is its own voxel: the output is the valid points in
    # (z, y, x) cell order
    assert int(got.mask.sum()) == int(tc.mask.sum())
    _same_cloud(got, want, atol=0.0)


def test_voxel_downsample_dense_voxels(rng):
    """Many points per voxel (a 0.5 leaf over a 2 m box: 64 cells)."""
    jc, tc = _cloud(rng, n=3000, attrs=("normal",))
    want = jvg.voxel_downsample(jc, 0.5)
    got = filters.voxel_downsample(tc, 0.5)
    _same_cloud(got, want, atol=1e-6)
    assert int(got.mask.sum()) == 64


@pytest.mark.parametrize("name,leaf", LEAVES, ids=[x[0] for x in LEAVES])
def test_uniform_sample_exact(rng, name, leaf):
    jc, tc = _cloud(rng)
    want = jvg.uniform_sample(jc, leaf)
    got = filters.uniform_sample(tc, leaf)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    for k, v in want.attrs.items():
        np.testing.assert_array_equal(got.attrs[k].numpy(), np.asarray(v), err_msg=k)
