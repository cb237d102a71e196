"""The CUDA kernels of pcl_tpu_torch against their plain PyTorch versions.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode). They import neither JAX nor pcl_tpu, so they run on a GPU machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pcl_tpu_torch import features, filters
from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.ops import nn1 as nn1_mod
from pcl_tpu_torch.ops import segsum
from pcl_tpu_torch.registration import icp as icp_mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, nq, m, valid_frac, dup=False):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-50, 50, size=(m, 3)).astype(np.float32)
    if dup:
        t[m // 2:] = t[: m - m // 2].copy()
    q = rng.uniform(-50, 50, size=(nq, 3)).astype(np.float32)
    if dup:
        q[: nq // 2] = t[rng.integers(0, m, nq // 2)]
    tm = rng.uniform(size=m) < valid_frac
    return t, tm, q


@pytest.mark.parametrize("nq,m,valid_frac,dup", [
    (1000, 3001, 0.9, False),      # ragged, masked
    (77, 500, 0.0, False),         # no valid target
    (513, 4097, 1.0, True),        # exact ties
    (5, 0, 1.0, False),            # empty target
    (20000, 30000, 1.0, False),
])
def test_nn1_kernel_matches_plain(cuda, nq, m, valid_frac, dup):
    t, tm, q = (torch.from_numpy(a).to(cuda) for a in _inputs(0, nq, m, valid_frac, dup))
    before = nn1_mod.nn1.launches
    ik, dk = nn1_mod.nn1(t, tm, q)
    ip, dp = nn1_mod.nn1_plain(t, tm, q)
    torch.cuda.synchronize()
    assert nn1_mod.nn1.launches == before + 1
    # the plain version repeats the kernel's float32 arithmetic: equal
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


def test_nn1_kernel_rejects(cuda):
    t = torch.zeros((10, 3), device=cuda)
    tm = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="3-D"):
        nn1_mod.nn1(torch.zeros((10, 6), device=cuda), tm, torch.zeros((4, 6), device=cuda))
    with pytest.raises(TypeError):
        nn1_mod.nn1(t.double(), tm, t.double())
    with pytest.raises(ValueError, match="contiguous"):
        nn1_mod.nn1(t.t().contiguous().t(), tm, t)
    with pytest.raises(ValueError, match="different devices"):
        nn1_mod.nn1(t, tm.cpu(), t)


def test_icp_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    tgt = rng.uniform(-1, 1, size=(2048, 3)).astype(np.float32)
    a = 0.1
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    src = (tgt @ R.T + np.float32([0.05, -0.03, 0.02])).astype(np.float32)
    on_card = icp_mod.icp(make_cloud(src), make_cloud(tgt), max_iterations=30)
    on_cpu = icp_mod.icp(make_cloud(src, device="cpu"), make_cloud(tgt, device="cpu"),
                         max_iterations=30)
    assert int(on_card.iterations) == int(on_cpu.iterations)
    assert int(on_card.convergence_state) == int(on_cpu.convergence_state)
    # float32 reductions in another order: transforms within 1e-5
    np.testing.assert_allclose(on_card.transform.cpu().numpy(), on_cpu.transform.numpy(),
                               atol=1e-5)


def _segments(seed, n, w, p_new, valid_frac, tail):
    rng = np.random.default_rng(seed)
    steps = (rng.random(n) < p_new).astype(np.int32)
    if n:
        steps[0] = 0
    seg = np.cumsum(steps).astype(np.int32)
    nvalid = int(n * valid_frac)
    seg[nvalid:] = n if tail == "n" else 2 ** 28
    vals = rng.normal(size=(n, w)).astype(np.float32)
    vals[nvalid:] = 0.0
    return vals, seg


@pytest.mark.parametrize("n,w,p_new,valid_frac,tail", [
    (100003, 4, 0.3, 0.9, "n"),        # N not a multiple of any block size
    (120000, 4, 0.0, 1.0, "n"),        # one segment of every row
    (120000, 4, 1.0, 1.0, "n"),        # every row its own segment
    (5000, 4, 0.3, 0.0, "n"),          # no valid row
    (0, 4, 0.3, 1.0, "n"),             # no row at all
    (7777, 1, 0.5, 0.8, "2**28"),
    (7777, 7, 0.5, 0.8, "2**28"),
    (7777, 131, 0.5, 0.8, "n"),        # past the TPU kernel's 120 lanes
])
def test_segsum_kernel_matches_plain(cuda, n, w, p_new, valid_frac, tail):
    vals, seg = (torch.from_numpy(a).to(cuda)
                 for a in _segments(1, n, w, p_new, valid_frac, tail))
    before = segsum.segment_sum_sorted.launches
    k1 = segsum.segment_sum_sorted(vals, seg)
    k2 = segsum.segment_sum_sorted(vals, seg)
    plain = segsum.segment_sum_sorted_plain(vals, seg)
    torch.cuda.synchronize()
    assert segsum.segment_sum_sorted.launches == before + (2 if n else 0)
    assert torch.equal(k1, k2)                 # no atomics: bitwise deterministic
    # both add a segment's rows in ascending order from 0: the tolerance
    # 1e-6 sum|v| only absorbs a different rounding order, were there one
    mag = segsum.segment_sum_sorted_plain(vals.abs(), seg)
    assert bool(((k1 - plain).abs() <= 1e-6 * mag.sum(1, keepdim=True)).all())
    live = segsum.segment_sum_sorted_plain(torch.ones_like(vals[:, :1]), seg)[:, 0] > 0
    assert bool((k1[~live] == 0).all())


def test_segsum_kernel_rejects(cuda):
    v = torch.zeros((10, 3), device=cuda)
    s = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        segsum.segment_sum_sorted(v.double(), s)
    with pytest.raises(TypeError):
        segsum.segment_sum_sorted(v, s.long())
    with pytest.raises(ValueError, match="contiguous"):
        segsum.segment_sum_sorted(v.t().contiguous().t(), s)
    with pytest.raises(ValueError, match="different devices"):
        segsum.segment_sum_sorted(v, s.cpu())


def test_voxel_front_end_on_card_matches_cpu(cuda):
    """voxel_downsample launches B2 once; its cloud and the normals on it
    agree with the CPU run (plain segment sum, plain searches)."""
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-5, 5, size=(20000, 3)).astype(np.float32)
    xyz[:, 2] = 0.1 * np.sin(xyz[:, 0])            # a gently curved sheet
    inten = rng.random(20000).astype(np.float32)
    before = segsum.segment_sum_sorted.launches
    on_card = filters.voxel_downsample(make_cloud(xyz, attrs={"intensity": inten}), 0.2)
    torch.cuda.synchronize()
    assert segsum.segment_sum_sorted.launches == before + 1
    on_cpu = filters.voxel_downsample(
        make_cloud(xyz, attrs={"intensity": inten}, device="cpu"), 0.2)
    assert torch.equal(on_card.mask.cpu(), on_cpu.mask)
    m = on_cpu.mask
    np.testing.assert_allclose(on_card.xyz.cpu()[m].numpy(), on_cpu.xyz[m].numpy(), atol=1e-5)
    np.testing.assert_allclose(on_card.attrs["intensity"].cpu()[m].numpy(),
                               on_cpu.attrs["intensity"][m].numpy(), atol=1e-6)
    kw = dict(k=12, backend="cell", cell_size=0.6, cell_cap=96)
    n_card = features.estimate_normals(on_card, **kw).attrs["normal"].cpu()[m]
    n_cpu = features.estimate_normals(on_cpu, **kw).attrs["normal"][m]
    assert float(((n_card * n_cpu).sum(1)).min()) >= 1 - 1e-4


def test_voxel_downsample_past_2_30_cells_on_card(cuda):
    """Past 2^30 bounding-box cells (clusters over a 4 km cube at a 0.1 m
    leaf) the three-key sort feeds B2 too: one launch, and the CPU run's
    voxels. Both add each voxel's points in the same order; the tolerance,
    1e-6 of the coordinate scale, would absorb only another addition order."""
    rng = np.random.default_rng(6)
    centres = rng.uniform(-2000, 2000, size=(1500, 1, 3))
    xyz = (centres + rng.uniform(0, 0.15, size=(1500, 8, 3))).reshape(-1, 3).astype(np.float32)
    inten = rng.random(len(xyz)).astype(np.float32)
    before = segsum.segment_sum_sorted.launches
    on_card = filters.voxel_downsample(
        make_cloud(xyz, attrs={"intensity": inten}, capacity=14000), 0.1)
    torch.cuda.synchronize()
    assert segsum.segment_sum_sorted.launches == before + 1
    on_cpu = filters.voxel_downsample(
        make_cloud(xyz, attrs={"intensity": inten}, capacity=14000, device="cpu"), 0.1)
    assert torch.equal(on_card.mask.cpu(), on_cpu.mask)
    assert int(on_cpu.mask.sum()) < len(xyz)         # voxels of several points
    np.testing.assert_allclose(on_card.xyz.cpu().numpy(), on_cpu.xyz.numpy(), atol=2e-3)
    np.testing.assert_allclose(on_card.attrs["intensity"].cpu().numpy(),
                               on_cpu.attrs["intensity"].numpy(), atol=1e-6)

