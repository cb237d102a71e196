"""The CUDA kernels of pcl_tpu_torch against their plain PyTorch versions.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode). They import neither JAX nor pcl_tpu, so they run on a GPU machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import numpy as np
import pytest
import torch

from pcl_tpu_torch import features, filters
from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.ops import nn1 as nn1_mod
from pcl_tpu_torch.ops import segsum
from pcl_tpu_torch.registration.gicp import gicp
from pcl_tpu_torch.registration.icp import icp
from pcl_tpu_torch.registration.ndt import build_grid, ndt
from pcl_tpu_torch.search import bruteforce
from pcl_tpu_torch.utils import trace


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _b1() -> int:
    """Launches of kernel B1 so far, as the port's recorder counts them."""
    return trace.counts().get("ops.nn1.launches", 0)


def _b2() -> int:
    """Launches of kernel B2 so far."""
    return trace.counts().get("ops.segsum.launches", 0)


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
    before = _b1()
    ik, dk = nn1_mod.nn1(t, tm, q)
    ip, dp = nn1_mod.nn1_plain(t, tm, q)
    torch.cuda.synchronize()
    assert _b1() == before + 1
    # the plain version repeats the kernel's float32 arithmetic: equal
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


def _tie_case():
    """Exact ties whose two copies sit either side of a sub-tile (32, 64, 128
    targets), a 2048-target tile and a slice boundary (3 slices of 2048, 7 of
    896), and far apart; the queries sit on the tied points."""
    rng = np.random.default_rng(7)
    t = rng.uniform(-5, 5, size=(6000, 3)).astype(np.float32)
    edges = [32, 64, 128, 896, 1792, 2048, 2688, 4096, 5376]
    for b in edges:
        t[b] = t[b - 1]
    t[5000] = t[5]
    q = np.concatenate([t[edges], t[[5]], rng.uniform(-5, 5, size=(90, 3)).astype(np.float32)])
    return t, np.ones(6000, bool), q


def _ragged_case():
    """Q and M multiples of nothing; the winner of the first 200 queries is
    the last target, in a ragged sub-tile."""
    rng = np.random.default_rng(8)
    t = rng.uniform(-5, 5, size=(2082, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, size=(1025, 3)).astype(np.float32)
    q[:200] = t[-1] + np.float32(1e-3)
    return t, np.ones(2082, bool), q


def _origin_case():
    """A query on a target at the origin, three times in the target: the
    scores +0.0 and -0.0 tie, and the lowest index wins."""
    rng = np.random.default_rng(9)
    t = rng.uniform(-5, 5, size=(300, 3)).astype(np.float32)
    t[[3, 70, 257]] = 0.0
    t[70] = -0.0
    q = np.concatenate([np.zeros((2, 3), np.float32),
                        rng.uniform(-5, 5, size=(30, 3)).astype(np.float32)])
    q[1] = -0.0
    return t, np.ones(300, bool), q


def _tiny_case():
    rng = np.random.default_rng(10)
    return (rng.uniform(-5, 5, size=(17, 3)).astype(np.float32), np.ones(17, bool),
            rng.uniform(-5, 5, size=(3, 3)).astype(np.float32))


@pytest.mark.parametrize("make,slices", [
    (_tie_case, None), (_tie_case, 1), (_tie_case, 3), (_tie_case, 7),
    (_ragged_case, None), (_ragged_case, 1), (_ragged_case, 5),
    (_origin_case, None), (_origin_case, 2), (_tiny_case, None), (_tiny_case, 4),
])
def test_nn1_kernel_edges_match_plain(cuda, make, slices):
    """Ties across sub-tiles, tiles and slices, ragged edges, the two zeros,
    fewer targets than a sub-tile: the kernel equals plain bit for bit
    whatever the number of slices."""
    t, tm, q = (torch.from_numpy(a).to(cuda) for a in make())
    ik, dk = nn1_mod.nn1(t, tm, q, slices=slices)
    ip, dp = nn1_mod.nn1_plain(t, tm, q)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


def test_nn1_kernel_few_queries_against_a_dense_map(cuda):
    """2048 queries against 120,000 targets: the targets are cut into
    slices so that the blocks fill the card; equal to plain."""
    t, tm, q = (torch.from_numpy(a).to(cuda) for a in _inputs(11, 2048, 120_000, 0.95))
    slices, slice_len = nn1_mod.nn1_plan(
        2048, 120_000, nn1_mod.device_slots(torch.cuda.current_device()))
    assert slices > 16 and slices * slice_len >= 120_000
    ik, dk = nn1_mod.nn1(t, tm, q)
    ip, dp = nn1_mod.nn1_plain(t, tm, q)
    torch.cuda.synchronize()
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
    with pytest.raises(ValueError, match="slices"):
        nn1_mod.nn1(t, tm, t, slices=0)


def test_icp_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    tgt = rng.uniform(-1, 1, size=(2048, 3)).astype(np.float32)
    a = 0.1
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    src = (tgt @ R.T + np.float32([0.05, -0.03, 0.02])).astype(np.float32)
    on_card = icp(make_cloud(src), make_cloud(tgt), max_iterations=30)
    on_cpu = icp(make_cloud(src, device="cpu"), make_cloud(tgt, device="cpu"),
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
    before = _b2()
    k1 = segsum.segment_sum_sorted(vals, seg)
    k2 = segsum.segment_sum_sorted(vals, seg)
    plain = segsum.segment_sum_sorted_plain(vals, seg)
    torch.cuda.synchronize()
    assert _b2() == before + (2 if n else 0)
    assert torch.equal(k1, k2)                 # no atomics: bitwise deterministic
    # both add a segment's rows in ascending order from 0: the tolerance
    # 1e-6 sum|v| only absorbs a different rounding order, were there one
    mag = segsum.segment_sum_sorted_plain(vals.abs(), seg)
    assert bool(((k1 - plain).abs() <= 1e-6 * mag.sum(1, keepdim=True)).all())
    live = segsum.segment_sum_sorted_plain(torch.ones_like(vals[:, :1]), seg)[:, 0] > 0
    assert bool((k1[~live] == 0).all())


def _check_segsum(vals, seg):
    """Kernel twice and plain: bitwise repeatable; equal to the sum in row
    order (the plain version on CPU tensors: a sequential loop) on every run
    that one thread adds alone; within 1e-6 sum|v| of the plain version on
    the card on longer runs (the block adds those in another fixed order);
    rows without members 0."""
    k1 = segsum.segment_sum_sorted(vals, seg)
    k2 = segsum.segment_sum_sorted(vals, seg)
    plain = segsum.segment_sum_sorted_plain(vals, seg)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    members = segsum.segment_sum_sorted_plain(torch.ones_like(vals[:, :1]), seg)[:, 0]
    short = (members <= segsum.SEQUENTIAL_ROWS).cpu()
    in_row_order = segsum.segment_sum_sorted_plain(vals.cpu(), seg.cpu())
    assert torch.equal(k1.cpu()[short], in_row_order[short])
    mag = segsum.segment_sum_sorted_plain(vals.abs(), seg).sum(1, keepdim=True)
    assert bool(((k1 - plain).abs() <= 1e-6 * mag).all())
    assert bool((k1[members == 0] == 0).all())
    return int((~short).sum())


@pytest.mark.parametrize("n,w,valid_frac", [(120000, 4, 1.0), (50000, 7, 0.95),
                                            (30000, 8, 0.9), (5000, 131, 1.0)])
def test_segsum_kernel_long_runs(cuda, n, w, valid_frac):
    """Runs of ~500 rows go to the block's shared, fixed-order sum."""
    vals, seg = (torch.from_numpy(a).to(cuda)
                 for a in _segments(2, n, w, 0.002, valid_frac, "n"))
    assert _check_segsum(vals, seg) > 0


@pytest.mark.parametrize("w", [1, 4, 12])
def test_segsum_kernel_runs_around_the_sequential_limit(cuda, w):
    """Runs of one row less, as many, and one more than a thread adds alone."""
    L = segsum.SEQUENTIAL_ROWS
    lengths = np.tile([L - 1, L, L + 1], 150)
    seg = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    vals = np.random.default_rng(3).normal(size=(len(seg), w)).astype(np.float32)
    n_long = _check_segsum(torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda))
    assert n_long == 150


def test_segsum_kernel_gaps_between_ids(cuda):
    """Ids that skip (no caller makes them): the rows of the gaps are 0,
    those before the first id included."""
    rng = np.random.default_rng(4)
    n = 10_000
    steps = ((rng.random(n) < 0.2) * rng.integers(1, 4, n)).astype(np.int32)
    steps[0] = 2
    seg = np.cumsum(steps).astype(np.int32)
    seg[9000:] = 2 ** 28
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    _check_segsum(torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda))


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
    before = _b2()
    on_card = filters.voxel_downsample(make_cloud(xyz, attrs={"intensity": inten}), 0.2)
    torch.cuda.synchronize()
    assert _b2() == before + 1
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


def _surface_pair(seed=9, n=6000):
    """A curved sheet and two walls, and the same surface moved by a small
    rigid motion (an exact copy: both aligners can recover it)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    a[: n // 2, 2] = 0.2 * np.sin(a[: n // 2, 0]) + 0.1 * a[: n // 2, 1]
    a[n // 2: 3 * n // 4, 0] = -3.0
    a[3 * n // 4:, 1] = 3.0
    ang = 0.03
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    return (a @ R.T + np.float32([0.06, -0.04, 0.03])).astype(np.float32), a


def test_bruteforce_nn1_dispatch_on_card(cuda):
    """3-D searches launch kernel B1; a 6-D search takes the chunked matmul
    sweep and launches nothing."""
    rng = np.random.default_rng(10)
    t6 = torch.from_numpy(rng.normal(size=(3000, 6)).astype(np.float32)).to(cuda)
    q6 = torch.from_numpy(rng.normal(size=(500, 6)).astype(np.float32)).to(cuda)
    tm = torch.ones(3000, dtype=torch.bool, device=cuda)
    before = _b1()
    i3, d3 = bruteforce.nn1(t6[:, :3].contiguous(), tm, q6[:, :3].contiguous())
    assert _b1() == before + 1
    i6, d6 = bruteforce.nn1(t6, tm, q6)
    assert _b1() == before + 1
    c6 = bruteforce.nn1(t6.cpu(), tm.cpu(), q6.cpu())
    assert torch.equal(i6.cpu(), c6[0])
    np.testing.assert_allclose(d6.cpu().numpy(), c6[1].numpy(), atol=1e-4)


def test_build_grid_on_card(cuda):
    """One B2 launch per grid; two builds bitwise equal; the CPU run's voxels."""
    _, tgt = _surface_pair(n=40000)
    xyz = torch.from_numpy(tgt).to(cuda)
    mask = torch.ones(len(tgt), dtype=torch.bool, device=cuda)
    mask[::13] = False
    before = _b2()
    g1 = build_grid(xyz, mask, 1.0, table_size=1 << 14)
    torch.cuda.synchronize()
    assert _b2() == before + 1
    g2 = build_grid(xyz, mask, 1.0, table_size=1 << 14)
    for f in ("mean", "icov", "valid", "ckey1", "ckey2"):
        assert torch.equal(getattr(g1, f), getattr(g2, f)), f
    gc = build_grid(xyz.cpu(), mask.cpu(), 1.0, table_size=1 << 14)
    assert torch.equal(g1.valid.cpu(), gc.valid) and int(gc.valid.sum()) > 50
    assert torch.equal(g1.ckey1.cpu(), gc.ckey1) and torch.equal(g1.ckey2.cpu(), gc.ckey2)
    # voxels of several hundred points: the kernel shares a long run among a
    # block in another order than the CPU's row order
    np.testing.assert_allclose(g1.mean.cpu().numpy(), gc.mean.numpy(), atol=1e-5)


def test_gicp_and_ndt_on_card_match_cpu(cuda):
    """Brute GICP launches B1 once per outer iteration; both aligners give
    the CPU run's pose (1e-3 m, 1e-4 in rotation entries: neighbour ties may
    move single covariances, ROADMAP C12, not the pose)."""
    src, tgt = _surface_pair()
    before = _b1()
    on_card = gicp(make_cloud(src), make_cloud(tgt), max_corr_dist=1.0)
    torch.cuda.synchronize()
    assert _b1() - before == int(on_card.iterations) > 0
    on_cpu = gicp(make_cloud(src, device="cpu"), make_cloud(tgt, device="cpu"),
                  max_corr_dist=1.0)
    assert bool(on_card.converged) and bool(on_cpu.converged)
    np.testing.assert_allclose(on_card.transform.cpu().numpy()[:3, 3],
                               on_cpu.transform.numpy()[:3, 3], atol=1e-3)
    np.testing.assert_allclose(on_card.transform.cpu().numpy()[:3, :3],
                               on_cpu.transform.numpy()[:3, :3], atol=1e-4)
    kw = dict(resolution=1.0, table_size=1 << 14)
    n_card = ndt(make_cloud(src), make_cloud(tgt), **kw)
    n_cpu = ndt(make_cloud(src, device="cpu"), make_cloud(tgt, device="cpu"), **kw)
    assert bool(n_card.converged) and bool(n_cpu.converged)
    np.testing.assert_allclose(n_card.transform.cpu().numpy()[:3, 3],
                               n_cpu.transform.numpy()[:3, 3], atol=1e-3)
    np.testing.assert_allclose(n_card.transform.cpu().numpy()[:3, :3],
                               n_cpu.transform.numpy()[:3, :3], atol=1e-4)


def test_voxel_downsample_past_2_30_cells_on_card(cuda):
    """Past 2^30 bounding-box cells (clusters over a 4 km cube at a 0.1 m
    leaf) the three-key sort feeds B2 too: one launch, and the CPU run's
    voxels. Both add each voxel's points in the same order; the tolerance,
    1e-6 of the coordinate scale, would absorb only another addition order."""
    rng = np.random.default_rng(6)
    centres = rng.uniform(-2000, 2000, size=(1500, 1, 3))
    xyz = (centres + rng.uniform(0, 0.15, size=(1500, 8, 3))).reshape(-1, 3).astype(np.float32)
    inten = rng.random(len(xyz)).astype(np.float32)
    before = _b2()
    on_card = filters.voxel_downsample(
        make_cloud(xyz, attrs={"intensity": inten}, capacity=14000), 0.1)
    torch.cuda.synchronize()
    assert _b2() == before + 1
    on_cpu = filters.voxel_downsample(
        make_cloud(xyz, attrs={"intensity": inten}, capacity=14000, device="cpu"), 0.1)
    assert torch.equal(on_card.mask.cpu(), on_cpu.mask)
    assert int(on_cpu.mask.sum()) < len(xyz)         # voxels of several points
    np.testing.assert_allclose(on_card.xyz.cpu().numpy(), on_cpu.xyz.numpy(), atol=2e-3)
    np.testing.assert_allclose(on_card.attrs["intensity"].cpu().numpy(),
                               on_cpu.attrs["intensity"].numpy(), atol=1e-6)



def test_hashgrid_on_card_matches_cpu(cuda):
    """The hash grid's build, kNN and radius search on the card: the CPU
    run's indices, validity, counts and truncation flags (both sum the same
    three squared differences; distances to 1e-6 relative)."""
    from pcl_tpu_torch.search import hashgrid

    rng = np.random.default_rng(11)
    xyz = rng.uniform(-3, 3, size=(20000, 3)).astype(np.float32)
    xyz[10000:10500] = xyz[:500]                     # exact ties
    mask = rng.random(20000) < 0.9
    q = torch.from_numpy(xyz[::7].copy())
    for table_size, cap in ((1 << 16, 32), (256, 8)):
        g = hashgrid.build(torch.from_numpy(xyz).to(cuda), torch.from_numpy(mask).to(cuda), 0.3,
                           table_size=table_size)
        gc = hashgrid.build(torch.from_numpy(xyz), torch.from_numpy(mask), 0.3,
                            table_size=table_size)
        assert torch.equal(g.sorted_idx.cpu(), gc.sorted_idx)
        assert torch.equal(g.bucket_start.cpu(), gc.bucket_start)
        for got, want in ((hashgrid.knn(g, q.to(cuda), 12, bucket_cap=cap),
                           hashgrid.knn(gc, q, 12, bucket_cap=cap)),
                          (hashgrid.radius(g, q.to(cuda), 0.3, 16, bucket_cap=cap),
                           hashgrid.radius(gc, q, 0.3, 16, bucket_cap=cap))):
            got = [x.cpu() for x in got]
            assert torch.equal(got[2], want[2])
            assert torch.equal(got[0][got[2]], want[0][want[2]])
            np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-6)
            for a, b in zip(got[3:], want[3:]):
                assert torch.equal(a, b)


def test_nn1_kernel_at_path_e_shape(cuda):
    """Queries outnumbering targets fifty to one (2048 x 1024 moved subset
    points against 40,000 voxels), exact ties and masked targets: the kernel
    equals its plain version on a slice of the queries."""
    rng = np.random.default_rng(12)
    t = rng.uniform(-30, 30, size=(40000, 3)).astype(np.float32)
    t[20000:20500] = t[:500]
    m = rng.random(40000) > 0.05
    q = rng.uniform(-30, 30, size=(2048 * 1024, 3)).astype(np.float32)
    q[::20] = t[rng.integers(0, 40000, len(q[::20]))]
    t, m, q = (torch.from_numpy(a).to(cuda) for a in (t, m, q))
    ik, dk = nn1_mod.nn1(t, m, q)
    ip, dp = nn1_mod.nn1_plain(t, m, q[: 1 << 17])
    assert torch.equal(ik[: 1 << 17], ip) and torch.equal(dk[: 1 << 17], dp)


def test_ia_core_on_card_matches_cpu(cuda):
    """The prerejective and SAC-IA cores on the card (B1 scores every
    hypothesis) against the CPU run on the same samples and candidates: the
    same best hypothesis, transforms to 1e-4."""
    from pcl_tpu_torch.core.cloud import Cloud
    from pcl_tpu_torch.registration import ia

    src, tgt = _surface_pair(n=5000)
    rng = np.random.default_rng(13)
    fs = rng.random((5000, 33)).astype(np.float32)
    ft = fs + rng.normal(scale=0.01, size=fs.shape).astype(np.float32)
    clouds = [make_cloud(a) for a in (src, tgt)]
    clouds_cpu = [Cloud(xyz=c.xyz.cpu(), mask=c.mask.cpu()) for c in clouds]
    cand = ia.feature_knn(torch.from_numpy(fs).to(cuda), clouds[0].mask,
                          torch.from_numpy(ft).to(cuda), clouds[1].mask, 5)
    draws = ia.draw_ia_samples(clouds_cpu[0].mask, 512, 3, 5, 256,
                               torch.Generator().manual_seed(1))
    before = _b1()
    for core in (ia.prerejective_core, ia.sac_ia_core):
        on_card = core(*clouds, cand, *(d.to(cuda) for d in draws))
        on_cpu = core(*clouds_cpu, cand.cpu(), *draws)
        np.testing.assert_allclose(on_card.transform.cpu().numpy(), on_cpu.transform.numpy(),
                                   atol=1e-4)
        assert abs(float(on_card.error) - float(on_cpu.error)) <= 1e-5
    assert _b1() == before + 2


# -- pose graph, KinFu mapping and integral normals (slice 6) ---------------

def _pose_graph(V=8, C=256, seed=14):
    """V poses along a chain with one loop edge; correspondences are scene
    points seen from both poses plus 0.01 m noise; initial poses drifted."""
    from pcl_tpu_torch.core.transforms import se3_exp

    rng = np.random.default_rng(seed)

    def step(rot, trans):
        xi = np.concatenate([rng.normal(size=3) * trans, rng.normal(size=3) * rot])
        return se3_exp(torch.tensor(xi, dtype=torch.float32)).double().numpy()

    true = [np.eye(4)]
    for _ in range(V - 1):
        true.append(true[-1] @ step(0.1, 0.5))
    scene = rng.normal(scale=3.0, size=(1000, 3))
    pairs = []
    for i, j in [(k, k + 1) for k in range(V - 1)] + [(0, V - 1)]:
        p = scene[rng.choice(len(scene), C, replace=False)]
        ti, tj = np.linalg.inv(true[i]), np.linalg.inv(true[j])
        pairs.append((i, j, (p @ ti[:3, :3].T + ti[:3, 3]).astype(np.float32),
                      (p @ tj[:3, :3].T + tj[:3, 3] + rng.normal(scale=0.01, size=p.shape))
                      .astype(np.float32)))
    init = np.stack([true[0]] + [step(0.01, 0.05) @ t for t in true[1:]]).astype(np.float32)
    return init, pairs, C


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_lum_on_card_matches_cpu(cuda, solver):
    """LUM on the card against the port's CPU run: poses within 1e-4 m and
    1e-4 rad (cuSOLVER and LAPACK round the solve differently)."""
    from pcl_tpu_torch.registration.graph import build_edges_from_correspondences, lum

    P, pairs, C = _pose_graph()
    runs = [lum(torch.from_numpy(P).to(dev), *build_edges_from_correspondences(pairs, C, dev),
                max_iterations=5, solver=solver) for dev in (cuda, "cpu")]
    a, b = (r.poses.cpu().double().numpy() for r in runs)
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() <= 1e-4
    R = np.einsum("vij,vkj->vik", a[:, :3, :3], b[:, :3, :3])
    assert np.abs(R - np.eye(3)).max() <= 1e-4
    assert int(runs[0].iterations) == int(runs[1].iterations) == 5


def _room_depth(pose, H=60, W=80, f=65.625):
    """Depth of a floor, a back wall and a box seen through a pinhole (camera
    frame: x right, y down, z forward), numpy."""
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = np.stack([(u - (W - 1) / 2) / f, (v - (H - 1) / 2) / f, np.ones((H, W))], -1)
    dw = d @ pose[:3, :3].T
    o = pose[:3, 3]
    best = np.full((H, W), np.inf)
    for axis, at in ((1, 1.0), (2, 2.6), (0, 1.2)):            # floor, back wall, side wall
        t = (at - o[axis]) / np.where(np.abs(dw[..., axis]) > 1e-9, dw[..., axis], 1e-9)
        best = np.where((t > 0) & (t < best), t, best)
    lo, hi = np.array([-0.4, 0.6, 1.6]), np.array([0.1, 1.0, 2.0])      # a box on the floor
    t0 = (lo - o) / np.where(np.abs(dw) > 1e-9, dw, 1e-9)
    t1 = (hi - o) / np.where(np.abs(dw) > 1e-9, dw, 1e-9)
    tn, tf = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
    best = np.where((tn < tf) & (tn > 0) & (tn < best), tn, best)
    return np.where(np.isfinite(best) & (best < 4.0), best, 0.0).astype(np.float32)


def _room_frames(n=4):
    from scipy.spatial.transform import Rotation

    tilt = np.eye(4)
    tilt[:3, :3] = Rotation.from_euler("x", -20, degrees=True).as_matrix()
    poses = []
    for k in range(n):
        step = np.eye(4)
        step[:3, :3] = Rotation.from_euler("y", 0.5 * k, degrees=True).as_matrix()
        step[:3, 3] = (0.01 * k, -0.005 * k, 0.004 * k)
        poses.append((step @ tilt).astype(np.float32))
    return poses, [_room_depth(p.astype(np.float64)) for p in poses]


def test_integrate_and_raycast_on_card_match_cpu(cuda):
    """96^3: weights equal and TSDF within 1e-5 on the card and the CPU but
    for voxels within rounding of a half pixel (at most 0.5%); raycast hits
    equal but for at most 0.5% of the pixels, vertices within 1e-4 m."""
    from pcl_tpu_torch.fusion import Intrinsics, integrate, make_volume, raycast

    intr = Intrinsics(65.625, 65.625, 39.5, 29.5)
    poses, depths = _room_frames(3)
    vols = [make_volume(96, 3.0, origin=(-1.5, -1.5, 0.0), device=dev) for dev in (cuda, "cpu")]
    for P, d in zip(poses, depths):
        vols = [integrate(v, torch.from_numpy(d).to(v.tsdf.device), intr,
                          torch.from_numpy(P).to(v.tsdf.device)) for v in vols]
    w_card, w_cpu = vols[0].weight.cpu(), vols[1].weight
    differ = (w_card != w_cpu) | ((vols[0].tsdf.cpu() - vols[1].tsdf).abs() > 1e-5)
    assert float(differ.float().mean()) <= 0.005 and float(w_cpu.max()) == 3.0
    maps = [raycast(v, intr, torch.from_numpy(poses[-1]).to(v.tsdf.device), 60, 80) for v in vols]
    hit_card, hit_cpu = maps[0][2].cpu(), maps[1][2]
    assert float((hit_card != hit_cpu).float().mean()) <= 0.005
    both = hit_card & hit_cpu
    assert float(both.float().mean()) > 0.8
    assert float((maps[0][0].cpu() - maps[1][0])[both].abs().max()) <= 1e-4


def test_kinfu_step_on_card_repeats_and_matches_cpu(cuda):
    """Two runs of four frames on the card are bitwise equal (the bilateral
    splat adds in a fixed order), and they track as the CPU run does: poses
    within 1e-4, ``lost`` equal."""
    from pcl_tpu_torch.fusion import Intrinsics, kinfu_init, kinfu_step, make_volume

    intr = Intrinsics(65.625, 65.625, 39.5, 29.5)
    poses, depths = _room_frames(4)

    def run(dev):
        s = kinfu_init(make_volume(96, 3.0, origin=(-1.5, -1.5, 0.0), device=dev), 60, 80,
                       torch.from_numpy(poses[0]).to(dev))
        out = []
        for d in depths:
            s = kinfu_step(s, torch.from_numpy(d).to(dev), intr)
            out.append(s)
        return out

    a, b, c = run(cuda), run(cuda), run("cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x.pose, y.pose) and torch.equal(x.volume.tsdf, y.volume.tsdf)
        assert torch.equal(x.prev_verts, y.prev_verts)
        assert (x.pose.cpu() - z.pose).abs().max() <= 1e-4
        assert bool(x.lost) == bool(z.lost) is False


def _syncs(fn) -> int:
    """The stream synchronisations ``fn`` makes, as PyTorch's sync debug
    mode reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen)


def test_transforms_do_not_synchronise(cuda):
    """``from_rt``, ``invert_rigid``, ``se3_exp`` and the Levenberg-Marquardt
    warps and Jacobians run inside every ICP, GICP, NDT, LUM and KinFu
    iteration: none of them waits for the stream."""
    from pcl_tpu_torch.core import transforms
    from pcl_tpu_torch.registration import estimation as est

    xi = torch.tensor([[0.1, -0.2, 0.3, 0.02, -0.01, 0.03], [0.1, 0.0, 0.0, 0.0, 0.0, 0.0]],
                      device=cuda)
    p3 = torch.tensor([0.2, -0.1, 0.05], device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T = transforms.se3_exp(xi)
        transforms.invert_rigid(T)
        transforms.from_rt(T[0, :3, :3], T[0, :3, 3])
        est.warp_rigid_6d_quat(xi)
        est.warp_rigid_3d(p3)
        est.warp_translation(p3)
        for warp, p in ((est.warp_rigid_6d, xi[0]), (est.warp_rigid_6d, xi[1]),
                        (est.warp_rigid_3d, p3), (est.warp_translation, p3),
                        (est.warp_rigid_6d_quat, xi[0])):
            est.warp_jacobian(warp, p)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_icp_iterations_synchronise_once_at_most(cuda, monkeypatch):
    """KinFu's ICP reads nothing back: a step with 1 ICP iteration a level
    and one with 6 synchronise alike. Point-to-plane ICP reads back one
    code an iteration and nothing more."""
    from pcl_tpu_torch.fusion import Intrinsics, kinfu, kinfu_init, kinfu_step, make_volume

    intr = Intrinsics(65.625, 65.625, 39.5, 29.5)
    poses, depths = _room_frames(2)
    s = kinfu_init(make_volume(96, 3.0, origin=(-1.5, -1.5, 0.0), device=cuda), 60, 80,
                   torch.from_numpy(poses[0]).to(cuda))
    s = kinfu_step(s, torch.from_numpy(depths[0]).to(cuda), intr)
    d1 = torch.from_numpy(depths[1]).to(cuda)
    counts = []
    for n in (1, 6):
        monkeypatch.setattr(kinfu, "LEVEL_ITERS", (n, n, n))
        counts.append(_syncs(lambda: kinfu_step(s, d1, intr)))
    assert counts[0] == counts[1]

    rng = np.random.default_rng(8)
    xy = rng.uniform(-1, 1, size=(3000, 2)).astype(np.float32)
    pts = np.column_stack([xy, 0.2 * np.sin(3 * xy[:, 0]) * np.cos(2 * xy[:, 1])])
    tgt = features.estimate_normals(make_cloud(pts.astype(np.float32), device=cuda), k=12)
    src = make_cloud((pts + np.float32([0.03, -0.02, 0.01])).astype(np.float32), device=cuda)
    kw = dict(variant="point_to_plane", abs_mse_eps=0.0, rel_mse_eps=0.0)
    runs = {n: _syncs(lambda: icp(src, tgt, max_iterations=n, **kw)) for n in (2, 6)}
    assert runs[6] - runs[2] == 4


@pytest.mark.parametrize("mode", ["covariance", "gradient"])
def test_integral_normals_on_card_match_cpu(cuda, mode):
    """60 x 80, a frame of 1 cm pixels about the origin: normals n.n' >=
    1 - 1e-5 on the pixels whose 9 x 9 windows are well conditioned against
    the rounding of the integral images (ROADMAP C26; measured on this frame
    on the CPU: 92% of them), zero normals in the same places."""
    from pcl_tpu_torch.features import integral_image_normals

    r, c = np.meshgrid(np.arange(60), np.arange(80), indexing="ij")
    x, y = (c - 40) * 0.01, (r - 30) * 0.01
    xyz = np.stack([x, y, 0.05 * np.sin(9 * x) * np.cos(7 * y) + 0.2 * y], -1).astype(np.float32)
    valid = np.ones((60, 80), bool)
    valid[10:20, 10:20] = False
    vp = torch.tensor([0.0, 0.0, -3.0])
    n_card, n_cpu = (integral_image_normals(torch.from_numpy(xyz).to(dev),
                                            torch.from_numpy(valid).to(dev), smoothing_size=9,
                                            viewpoint=vp.to(dev), mode=mode)[0].cpu()
                     for dev in (cuda, "cpu"))
    assert torch.equal(n_card.abs().sum(-1) == 0, n_cpu.abs().sum(-1) == 0)
    dots = (n_card * n_cpu).sum(-1)[n_cpu.abs().sum(-1) > 0]
    assert float((dots >= 1 - 1e-5).float().mean()) >= 0.9


def test_lum_tool_launches_b1(cuda, tmp_path, capsys):
    """tools.lum on the card (its default device): B1 once per edge."""
    from pcl_tpu_torch import io
    from pcl_tpu_torch.tools import lum as lum_tool

    rng = np.random.default_rng(15)
    base = rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32)
    files = []
    for i, off in enumerate([(0, 0, 0), (0.05, 0, 0), (0, 0.05, 0)]):
        files.append(str(tmp_path / f"scan{i}.pcd"))
        io.save(files[-1], make_cloud(base + np.float32(off), device="cpu"))
    before = _b1()
    assert lum_tool.main([*files, "-corr_dist", "0.5", "-max_corr", "256"]) == 0
    assert _b1() == before + 3
    assert "[lum] 3 edges, 3 vertices" in capsys.readouterr().out


def _height_pair(n=400, seed=5):
    """A height field and its rigidly moved copy (both on the CPU)."""
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                           0.3 * np.sin(rng.uniform(-3, 3, n))]).astype(np.float32)
    a = 0.8
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    return pts, (pts @ R.T + np.float32([0.4, -0.3, 0.2])).astype(np.float32)


def test_fpcs_cores_repeat_bitwise_on_card(cuda):
    """Two runs of each batched FPCS core on the same draws: the same
    transform and error, bit for bit (B1's sweep and the stable sorts are
    deterministic), and the best hypothesis is a live one. The congruence
    tolerance is 0.1 m, half the pair's point spacing, with 32 target pairs
    a base: on this pair ten CPU draws gave 50-70 valid FPCS hypotheses of
    2,048 and 100-250 valid 4PCS ones of 512 (at 0.05 m and 8 pairs, 0-6
    FPCS ones)."""
    from pcl_tpu_torch.registration import fpcs

    src, dst = (make_cloud(p, device=cuda) for p in _height_pair())
    g = torch.Generator(device=cuda).manual_seed(3)
    d3 = fpcs.draw_fpcs_samples(src.mask, dst.mask, 64, 256, 32, 256, g)
    d4 = fpcs.draw_fpcs4_samples(src.mask, dst.mask, 32, 192, 256, g)
    for run in (lambda: fpcs.fpcs_core(src, dst, *d3, delta=0.1),
                lambda: fpcs.fpcs4_core(src, dst, *d4, delta=0.1, pairs_per_base=128,
                                        n_hyp=512)):
        before = _b1()
        a, b = run(), run()
        assert _b1() == before + 2
        assert bool(a.valid)
        assert torch.equal(a.transform, b.transform) and torch.equal(a.error, b.error)


def test_hausdorff_launches_b1_twice(cuda):
    from pcl_tpu_torch.core.geometry import hausdorff

    a, b = _height_pair(3000)
    am = np.arange(3000) % 7 != 0
    before = _b1()
    h_card = hausdorff(*(torch.from_numpy(x).to(cuda) for x in (a, am, b, np.ones(3000, bool))))
    assert _b1() == before + 2
    h_cpu = hausdorff(*(torch.from_numpy(x) for x in (a, am, b, np.ones(3000, bool))))
    assert float(h_card) == float(h_cpu)                  # the plain version's contract


def test_fpcs4_align_host_launches_b1_per_matched_base(cuda, monkeypatch):
    """B1 once for each base whose two diagonals both have target pairs
    within 2 delta, and once more for the scoring; the result equals the
    CPU run's."""
    from pcl_tpu_torch.registration import fpcs

    pts, dst = _height_pair()
    pts, dst = pts[:150], dst[:150]
    bases = []
    real = fpcs._host_base

    def spy(*a):
        out = real(*a)
        bases.append(out)
        return out

    monkeypatch.setattr(fpcs, "_host_base", spy)
    kw = dict(delta=0.05, overlap=0.9, n_bases=8, n_eval=128, seed=0)
    before = _b1()
    res = fpcs.fpcs4_align_host(make_cloud(pts, device=cuda), make_cloud(dst, device=cuda), **kw)
    launches = _b1() - before
    plen = np.linalg.norm(dst[:, None].astype(np.float64) - dst[None], axis=-1)
    np.fill_diagonal(plen, np.inf)
    matched = sum(1 for b in bases if b is not None and all(
        (np.abs(plen - np.linalg.norm(q - p)) < 0.1).any() for p, q in ((b[0], b[1]), (b[2], b[3]))))
    assert matched >= 1 and launches == matched + 1
    bases.clear()
    cpu = fpcs.fpcs4_align_host(make_cloud(pts, device="cpu"), make_cloud(dst, device="cpu"), **kw)
    assert bool(res.valid) == bool(cpu.valid)
    assert float((res.transform.cpu() - cpu.transform).abs().max()) <= 1e-5


def test_ndt_2d_on_card_matches_cpu(cuda):
    """Two Newton iterations at one level: the parameters to 1e-5 (the
    score's sums and the grid's segment sums round alike up to order)."""
    from pcl_tpu_torch.registration.ndt2d import ndt_2d

    rng = np.random.default_rng(42)
    t = rng.uniform(0, 4, 750).astype(np.float32)
    xy = np.concatenate([np.stack([t, np.zeros_like(t)], 1), np.stack([np.zeros_like(t), t], 1)])
    xy += rng.normal(scale=0.01, size=xy.shape).astype(np.float32)
    c, s = np.cos(0.08), np.sin(0.08)
    src_xy = (xy - np.float32([0.15, -0.1])) @ np.array([[c, -s], [s, c]], np.float32)
    z = np.zeros((len(xy), 1), np.float32)
    src, tgt = np.concatenate([src_xy, z], 1), np.concatenate([xy, z], 1)
    out = [ndt_2d(make_cloud(src, device=d), make_cloud(tgt, device=d), grid_extent=0.8,
                  max_iterations=2, levels=1) for d in (cuda, "cpu")]
    np.testing.assert_allclose(out[0].params.cpu().numpy(), out[1].params.numpy(), atol=1e-5)
    assert int(out[0].iterations) == int(out[1].iterations)


def _sharded_pair(n=20000, seed=21):
    """A noisy pair in a 20 m cube, the source moved by 2 deg and 0.1 m."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    a = np.radians(2.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    src = ((tgt + rng.normal(scale=0.01, size=tgt.shape)) @ R.T + [0.1, -0.05, 0.08])
    return src.astype(np.float32), tgt


def _sharded_icp_on(mesh):
    from pcl_tpu_torch.parallel import sharded_icp

    src, tgt = (torch.from_numpy(a).to(mesh.device) for a in _sharded_pair())
    ones = torch.ones(len(src), dtype=torch.bool, device=mesh.device)
    return sharded_icp(mesh, src, ones, tgt, ones, max_corr_dist=1.0, max_iterations=10,
                       corr_backend="brute")


def _gloo_rank(rank: int, store: str, out: str) -> None:
    """One of two ranks sharing the card (gloo, host staging)."""
    from pcl_tpu_torch.parallel import make_mesh, runtime

    runtime.initialize_multihost(init_method=f"file://{store}", num_processes=2,
                                 process_id=rank)
    mesh = make_mesh()
    assert mesh.backend == "gloo" and mesh.device.type == "cuda"
    before = _b1()
    T, _, _ = _sharded_icp_on(mesh)
    np.save(f"{out}/rank{rank}.npy", T.cpu().numpy())
    np.save(f"{out}/launches{rank}.npy", np.asarray(_b1() - before))
    torch.distributed.destroy_process_group()


def _one_rank_nccl():
    import torch.distributed as dist

    from pcl_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    mesh = make_mesh()
    try:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        before = _b1()
        runs = [_sharded_icp_on(mesh)[0] for _ in range(2)]
        return runs, _b1() - before, mesh.counts
    finally:
        dist.destroy_process_group()


def test_sharded_icp_one_rank_nccl_repeats_and_launches_b1(cuda):
    (T1, T2), launches, counts = _one_rank_nccl()
    assert torch.equal(T1, T2)
    assert launches == 2 * 10                      # B1 once an iteration
    assert counts["psum"] == [20, 20 * 18 * 4]
    src, tgt = _sharded_pair()
    ref = icp(make_cloud(src), make_cloud(tgt), max_corr_dist=1.0, max_iterations=10,
              corr_backend="brute")
    # Umeyama from summed moments against estimate_svd: another rounding
    np.testing.assert_allclose(T1.cpu().numpy(), ref.transform.cpu().numpy(), atol=1e-4)


def test_sharded_icp_two_gloo_ranks_on_one_card_match_nccl(cuda, tmp_path):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    (T, _), _, _ = _one_rank_nccl()
    for r in range(2):
        assert int(np.load(tmp_path / f"launches{r}.npy")) == 10
        np.testing.assert_allclose(np.load(tmp_path / f"rank{r}.npy"), T.cpu().numpy(),
                                   atol=1e-4)
    np.testing.assert_array_equal(np.load(tmp_path / "rank0.npy"), np.load(tmp_path / "rank1.npy"))


def test_pose_graph_sharded_backend_on_card_leaves_no_group(cuda):
    """``lum_sharded`` with no mesh runs on a one-rank NCCL group that it
    destroys before it returns; its poses are ``lum_cg``'s on the card within
    1e-4 m and rad (the same CG, its sums all-reduced)."""
    import torch.distributed as dist

    from pcl_tpu_torch.registration.graph_optimizer import PoseGraph

    P, pairs, _ = _pose_graph()

    def optimize(method):
        g = PoseGraph()
        for p in P:
            g.add_vertex(p)
        for i, j, s, d in pairs:
            g.add_edge(i, j, s, d)
        return np.asarray(g.optimize(method, max_iterations=4, cg_iters=64), np.float64)

    assert not dist.is_initialized()
    sharded = optimize("lum_sharded")
    assert not dist.is_initialized()
    cg = optimize("lum_cg")
    assert np.abs(sharded[:, :3, 3] - cg[:, :3, 3]).max() <= 1e-4
    R = np.einsum("vij,vkj->vik", sharded[:, :3, :3], cg[:, :3, :3])
    assert np.abs(R - np.eye(3)).max() <= 1e-4


def _street_corner(seed=0, n=3000):
    """Ground, a facade, a box and a ball with 5 mm of noise, an intensity,
    and normals from the port."""
    rng = np.random.default_rng(seed)
    m = n // 4
    g = rng.uniform([-2, 0, -2], [2, 0, 2], (m, 3))
    w = rng.uniform([-2, 0, 2], [2, 2, 2], (m, 3))
    box = rng.uniform([-0.5, 0, -0.3], [0.5, 0.6, 0.3], (m, 3))
    box[np.arange(m), rng.integers(0, 3, m)] = 0.5
    s = rng.normal(size=(n - 3 * m, 3))
    ball = 0.3 * s / np.linalg.norm(s, axis=1, keepdims=True) + [1.0, 0.5, 0.5]
    p = np.concatenate([g, w, box, ball])
    p = (p + rng.normal(scale=0.005, size=p.shape)).astype(np.float32)
    inten = (0.6 + 0.2 * np.sin(5 * p[:, 0]) * np.cos(3 * p[:, 2])).astype(np.float32)
    return p, inten


def test_shot_on_card_repeats_bitwise_and_matches_cpu(cuda):
    """SHOT's histograms go through ``index_put_(accumulate=True)``, which
    adds in index order on the card too (a stable sort): two runs are
    bitwise equal, and equal to the CPU run to 2e-5 on unit rows but for
    rows whose decisions float rounding turns (counted, at most 5%)."""
    from pcl_tpu_torch.features import shot

    p, _ = _street_corner()
    c = features.estimate_normals(make_cloud(p, device=cuda), k=12)
    a = shot.estimate_shot_interpolated(c, 0.3)
    b = shot.estimate_shot_interpolated(c, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    cpu = c.__class__(xyz=c.xyz.cpu(), mask=c.mask.cpu(),
                      attrs={k: v.cpu() for k, v in c.attrs.items()})
    err = (a.cpu() - shot.estimate_shot_interpolated(cpu, 0.3)).abs().amax(1)
    assert float((err > 2e-5).float().mean()) <= 0.05


def test_sift_launches_b2_an_octave_and_b1_once(cuda):
    from pcl_tpu_torch.keypoints import sift

    p, inten = _street_corner(1, 20000)
    c = make_cloud(p, device=cuda).with_attrs(intensity=torch.from_numpy(inten).to(cuda))
    b1, b2 = _b1(), _b2()
    mask, scale = sift.sift_keypoints(c, 0.05, n_octaves=3)
    torch.cuda.synchronize()
    assert _b2() - b2 == 3
    assert _b1() - b1 == 1
    assert int(mask.sum()) > 0 and bool((scale[mask] > 0).all())
    kp = sift.sift_keypoints_cloud(c, 0.05, n_octaves=3)
    cpu = sift.sift_keypoints_cloud(make_cloud(p, device="cpu").with_attrs(
        intensity=torch.from_numpy(inten)), 0.05, n_octaves=3)
    # the octaves are voxel grids, bitwise alike on both devices (C11), and
    # the difference of Gaussians adds in another order: the same keypoints
    # but for extrema within rounding of a neighbour
    assert abs(int(kp.mask.sum()) - int(cpu.mask.sum())) <= 0.05 * int(cpu.mask.sum()) + 1


def _ball(seed=0, n=800):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xyz = (np.array([0.0, 0.0, 2.0]) + (0.4 + 0.002 * rng.normal(size=(n, 1))) * d)
    return xyz.astype(np.float32), d.astype(np.float32)


def test_hoppe_launches_b1_once_a_grid_and_matches_cpu(cuda):
    """One B1 launch for the grid's R^3 queries; the SDF equal to the CPU
    run's (the same exact distances, bit for bit as kernel and plain agree)
    but at grid points within 8 ulp of a 1-NN tie (ROADMAP C55), the meshes
    equal when no sign differs."""
    from pcl_tpu_torch.surface import reconstruction

    xyz, nrm = _ball()
    clouds = [make_cloud(xyz, attrs={"normal": nrm}, device=d) for d in (cuda, "cpu")]
    lo, hi = reconstruction.hoppe_grid_bounds(clouds[1], 0.05)
    before = _b1()
    s_card = reconstruction.hoppe_signed_distance(clouds[0], lo, hi, 32).cpu().numpy()
    assert _b1() == before + 1
    s_cpu = reconstruction.hoppe_signed_distance(clouds[1], lo, hi, 32).numpy()
    q = reconstruction.grid_points(torch.from_numpy(lo), torch.from_numpy(hi), 32).numpy()
    d = ((q[:, None, :].astype(np.float64) - xyz[None].astype(np.float64)) ** 2).sum(-1)
    part = np.partition(d, 1, axis=1)
    scale = (q.astype(np.float64) ** 2).sum(1) + (xyz.astype(np.float64) ** 2).sum(1).max()
    firm = (part[:, 1] - part[:, 0] > 8 * 2.0 ** -23 * scale).reshape(s_cpu.shape)
    assert firm.mean() > 0.95
    np.testing.assert_allclose(s_card[firm], s_cpu[firm], atol=1e-6)
    (vc, fc), (vp, fp) = (reconstruction.surface_nets(s, lo, hi) for s in (s_card, s_cpu))
    if np.array_equal(s_card < 0, s_cpu < 0):
        assert np.array_equal(fc, fp)


def test_poisson_repeats_bitwise_on_card(cuda):
    """The splat adds by ``index_put_`` with accumulation (C28): two runs on
    the card are bitwise equal, and chi agrees with the CPU run to 1e-5 of
    its largest (C56)."""
    from pcl_tpu_torch.surface import poisson

    xyz, nrm = _ball(1)
    c = make_cloud(xyz, attrs={"normal": nrm}, device=cuda)
    gmin, _, cell, _ = poisson.poisson_bounds(c, 6, 1.15)
    runs = [poisson.indicator_grid(c.xyz, c.mask, c.attrs["normal"],
                                   torch.from_numpy(gmin).to(cuda),
                                   torch.from_numpy(cell).to(cuda), 64) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    cc = make_cloud(xyz, attrs={"normal": nrm}, device="cpu")
    chi_cpu, _, _ = poisson.indicator_grid(cc.xyz, cc.mask, cc.attrs["normal"],
                                           torch.from_numpy(gmin), torch.from_numpy(cell), 64)
    chi = runs[0][0].cpu()
    assert float((chi - chi_cpu).abs().max()) <= 1e-5 * float(chi_cpu.abs().max())
    V1, F1 = poisson.poisson_reconstruction(c, depth=6)
    V2, F2 = poisson.poisson_reconstruction(c, depth=6)
    assert np.array_equal(V1, V2) and np.array_equal(F1, F2) and len(F1) > 1000


def test_leaf_centroids_launch_b2_once_and_match_cpu(cuda):
    """``octree.leaf_centroids`` sums its sorted rows (xyz and a count) with
    one B2 launch; the tree, counts and leaf count equal the CPU run's, the
    centroids within 1e-6 of the coordinates' scale."""
    from pcl_tpu_torch import octree

    rng = np.random.default_rng(11)
    xyz = (rng.uniform(-20, 20, size=(30, 3))[rng.integers(0, 30, 20000)]
           + rng.normal(scale=0.4, size=(20000, 3))).astype(np.float32)
    mask = rng.uniform(size=20000) > 0.05
    out = []
    for dev in (cuda, torch.device("cpu")):
        x, m = torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev)
        tree = octree.build(x, m, 0.25)
        before = _b2()
        c, n, nl = octree.leaf_centroids(tree, x)
        launched = _b2() - before
        out.append((tree, c.cpu(), n.cpu(), int(nl), launched))
    (tc, cc, nc, lc, launched), (tp, cp, np_, lp, _) = out
    assert launched == 1
    assert all(torch.equal(getattr(tc, f).cpu(), getattr(tp, f))
               for f in ("keys", "order", "mask", "origin"))
    assert torch.equal(nc, np_) and lc == lp > 1000
    assert float((cc - cp).abs().max()) <= 1e-6 * float(np.abs(xyz).max())


def _instances(seed, n=400, H=5):
    """A model, a scene holding two moved copies of it, and hypotheses: the
    two true poses, one 4 mm off, one far away and one moved 0.15 m."""
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.1, 0.1, size=(n, 3)).astype(np.float32)
    Ts = np.tile(np.eye(4, dtype=np.float32), (H, 1, 1))
    Ts[0, :3, 3] = [0.5, 0, 0]
    Ts[1, :3, 3] = [-0.5, 0.2, 0]
    Ts[2, :3, 3] = [0.504, 0, 0]
    Ts[3, :3, 3] = [3.0, 3.0, 0]
    Ts[4, :3, 3] = [-0.5, 0.35, 0]
    scene = np.concatenate([model + Ts[0, :3, 3], model + Ts[1, :3, 3]])
    scene += rng.normal(scale=0.002, size=scene.shape).astype(np.float32)
    return model, Ts, scene.astype(np.float32)


@pytest.mark.parametrize("name,launches", [("greedy_hypothesis_verification", 1),
                                           ("global_hypothesis_verification", 6),
                                           ("papazov_hypothesis_verification", 1)])
def test_verifiers_launch_b1_and_match_cpu(cuda, name, launches):
    """Each verifier's 1-NN is kernel B1 on the card (the global one: one
    call per hypothesis and one of all moved model points); the accept masks
    equal the CPU run's."""
    from pcl_tpu_torch.recognition import verification

    model, Ts, scene = _instances(3)
    out = []
    for dev in (cuda, torch.device("cpu")):
        args = [torch.from_numpy(a).to(dev) for a in (model, Ts, np.ones(5, bool), scene,
                                                     np.ones(len(scene), bool))]
        before = _b1()
        acc = getattr(verification, name)(*args, inlier_threshold=0.01)
        out.append((acc.cpu(), _b1() - before))
    assert out[0][1] == launches and out[1][1] == 0
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][0][0] and out[0][0][1] and not out[0][0][3]


def test_hough_splat_repeats_bitwise_on_the_card(cuda):
    """Hough 3-D's trilinear splat adds many votes into shared buckets with
    ``index_put_(accumulate=True)``: two runs on the card are bitwise equal,
    and the instances equal the CPU run's."""
    from pcl_tpu_torch.recognition import grouping

    rng = np.random.default_rng(4)
    model = rng.normal(size=(3000, 3)).astype(np.float32)
    scene = model + np.float32([1.0, -0.5, 2.0])
    mp = np.concatenate([model, rng.normal(size=(1000, 3)).astype(np.float32)])
    sp = np.concatenate([scene, rng.uniform(-4, 4, (1000, 3)).astype(np.float32)])
    runs = []
    for dev in (cuda, cuda, torch.device("cpu")):
        t = [torch.from_numpy(a).to(dev) for a in (mp, sp, np.ones(len(mp), bool),
                                                  model.mean(0))]
        r = grouping.hough3d_grouping(*t, bin_size=0.2, threshold=10.0, max_instances=3)
        runs.append([x.cpu() for x in r])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert torch.equal(runs[0][0], runs[2][0]) and torch.equal(runs[0][1], runs[2][1])
    assert bool(runs[0][0][0]) and float((runs[0][2] - runs[2][2]).abs().max()) <= 1e-5


def _tracking_scene(seed=21):
    """An object near the origin, and a scene of it moved a little beside a
    floor patch."""
    rng = np.random.default_rng(seed)
    obj = rng.uniform([-0.1, -0.15, -0.05], [0.25, 0.15, 0.05], (200, 3)).astype(np.float32)
    scene = np.concatenate([obj + [0.01, -0.006, 0.004],
                            np.stack([rng.uniform(-0.6, 0.6, 600), np.full(600, -0.3),
                                      rng.uniform(-0.6, 0.6, 600)], 1)]).astype(np.float32)
    return obj, scene


@pytest.mark.parametrize("tracker", ["pf", "kld"])
def test_tracker_step_launches_b1_once_and_matches_cpu(cuda, tracker):
    """One step of each particle filter scores every particle in one B1
    launch; on the same CPU draws and state the card's MAP pose equals the
    CPU run's to 1e-4, and its particles row by row to 1e-4 but for rows
    whose sample point lies within 1e-4 of a cumulative-weight edge."""
    from pcl_tpu_torch.tracking import kld, particle_filter as pf

    obj, scene = _tracking_scene()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ref, sc = make_cloud(obj, device=dev), make_cloud(scene, device=dev)
        g = torch.Generator()
        g.manual_seed(4)
        sn = torch.tensor([0.01] * 3 + [0.02] * 3, device=dev)
        if tracker == "pf":
            st = pf.init_tracker(300, device=dev)
            draws = pf.draw_tracker_step(st, ref, g)
            weigh = pf.weigh(st, ref, sc, draws, sn)[1]
            before = _b1()
            new, pose = pf.step_tracker_core(st, ref, sc, draws, step_noise=sn)
        else:
            st = kld.init_kld_tracker(400, 250, device=dev)
            draws = kld.draw_kld_step(st, ref, g)
            weigh = kld.weigh_kld(st, ref, sc, draws, sn)[1]
            before = _b1()
            new, pose = kld.step_tracker_kld_core(st, ref, sc, draws, step_noise=sn,
                                                  bin_size=0.1, epsilon=0.2, z_delta=2.326)
        out[dev.type] = (_b1() - before, pose.cpu().numpy(),
                         new.particles.cpu().numpy(), weigh.cpu().numpy(), float(draws.u0))
    (launched, pa, xa, _, _), (_, pb, xb, wb, u0) = out["cuda"], out["cpu"]
    assert launched == 1
    np.testing.assert_allclose(pa, pb, atol=1e-4)
    cum = np.cumsum(wb.astype(np.float64)) / wb.sum()
    P = len(wb)
    near = np.abs(u0 + np.arange(P)[:, None] / P - cum[None, :]).min(1) <= 1e-4
    apart = np.abs(xa - xb).max(1) > 1e-4
    assert not (apart & ~near).any() and near.sum() <= P // 8


def test_lattice_splat_and_dense_crf_repeat_bitwise_on_card(cuda):
    """The permutohedral filter and both DenseCRF filters give the same bits
    on two card runs (the splats add in C28's order) and agree with the CPU
    run: the filter to 1e-5 of its largest value, the posteriors to 1e-4."""
    from pcl_tpu_torch.ml import densecrf, permutohedral

    rng = np.random.default_rng(8)
    n = 3000
    xyz = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    labels = (xyz[:, 0] > 0.5).astype(np.int64) + 2 * (rgb[:, 1] > 0.5)
    unary = np.full((n, 4), -np.log(0.2 / 3), np.float32)
    unary[np.arange(n), labels] = -np.log(0.8)
    feat = np.concatenate([xyz / 0.05, rgb / 0.1], 1)
    vals = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    runs = {}
    for dev, reps in ((cuda, 2), (torch.device("cpu"), 1)):
        for r in range(reps):
            f = permutohedral.PermutohedralFilter(feat, device=dev).compute(vals).cpu().numpy()
            qs = []
            for impl in ("permutohedral", "grid"):
                crf = densecrf.DenseCRF(n, 4, device=dev)
                crf.set_unary_energy(unary)
                crf.add_pairwise_gaussian(xyz, 0.05)
                crf.add_pairwise_bilateral(xyz, rgb, 0.2, 0.1, n_bins=6)
                qs.append(crf.inference(5, filter_impl=impl))
            runs[(dev.type, r)] = (f, qs)
    (fa, qa), (fb, qb), (fc, qc) = runs[("cuda", 0)], runs[("cuda", 1)], runs[("cpu", 0)]
    assert np.array_equal(fa, fb) and all(np.array_equal(x, y) for x, y in zip(qa, qb))
    np.testing.assert_allclose(fa, fc, atol=1e-5 * np.abs(fc).max())
    for x, y in zip(qa, qc):
        np.testing.assert_allclose(x, y, atol=1e-4)


def test_people_detector_grid_launches_b2_once(cuda):
    """Path O's detector front end: the frame's 0.06 m voxel grid is one B2
    launch, and the detections equal the CPU run's."""
    from pcl_tpu_torch.people import GroundBasedPeopleDetector

    rng = np.random.default_rng(9)
    floor = np.stack([rng.uniform(-2, 2, 20000), np.full(20000, 1.2),
                      rng.uniform(1.5, 5, 20000)], 1)
    th = rng.uniform(0, 2 * np.pi, 6000)
    person = np.stack([-0.5 + 0.18 * np.cos(th), 1.2 - rng.uniform(0.02, 1.7, 6000),
                       3.0 + 0.18 * np.sin(th)], 1)
    pts = (np.concatenate([floor, person]) + rng.normal(scale=0.003, size=(26000, 3))
           ).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        before = _b2()
        vox = filters.voxel_downsample(make_cloud(pts, device=dev), 0.06)
        launched = _b2() - before
        vox = vox.take(torch.nonzero(vox.mask)[:, 0])
        det = GroundBasedPeopleDetector(ground_coeffs=np.array([0.0, -1.0, 0.0, 1.2]))
        out[dev.type] = (launched, det.detect(vox))
    assert out["cuda"][0] == 1
    a, b = out["cuda"][1], out["cpu"][1]
    assert len(a) == len(b) == 1 and a[0].n_points == b[0].n_points
    np.testing.assert_allclose(a[0].centroid, b[0].centroid, atol=1e-5)
    assert abs(a[0].height - b[0].height) <= 1e-5


def _stereo_pair(seed=10, H=60, W=96, d=6):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, (H, W + d)).astype(np.float32)
    tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 0)) / 3
    return tex[:, d:].copy(), tex[:, :W].copy()      # left[x] = right[x - d]


def test_stereo_cloud_icp_launches_b2_once_and_b1_an_iteration(cuda):
    """Path P's (a) and (b) at a small size: both matchers' disparities on
    the card equal the CPU run's; the stereo cloud's voxel grid is one B2
    launch and brute ICP one B1 launch an iteration; the poses agree to
    1e-4."""
    from pcl_tpu_torch import stereo

    left, right = _stereo_pair()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        L, R = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
        bm = stereo.block_matching(L, R, max_disparity=12)
        ad = stereo.adaptive_cost_so_matching(L, R, max_disparity=12)
        cloud = stereo.disparity_to_cloud(bm, 60.0, 0.12)
        b2 = _b2()
        vox = filters.voxel_downsample(cloud, 0.02)
        b2 = _b2() - b2
        vox = vox.take(torch.nonzero(vox.mask)[:, 0])
        tgt = vox.xyz.cpu().numpy() + np.float32([0.01, 0.0, 0.02])
        b1 = _b1()
        r = icp(vox, make_cloud(tgt, device=dev), corr_backend="brute", max_iterations=10,
                max_corr_dist=0.1)
        b1 = _b1() - b1
        out[dev.type] = (bm.cpu().numpy(), ad.cpu().numpy(), b2, b1, int(r.iterations),
                         r.transform.cpu().numpy())
    a, b = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == 1 and a[3] == a[4] >= 1
    np.testing.assert_allclose(a[5], b[5], atol=1e-4)


def test_scan_voxels_launch_b2_once_and_surface_nn1_b1_once(cuda, tmp_path):
    """Path P's (e) at a small size: ``virtual_scanner``'s scans on the card
    lie within 1e-5 m of the CPU run's (the z-buffers round apart only at a
    half pixel); their voxel grid is one B2 launch and the 1-NN to the
    surface samples one B1 launch, equal to the plain version."""
    from pcl_tpu_torch.io import obj  # noqa: F401  (the OBJ reader on the card)
    from pcl_tpu_torch.tools.virtual_scanner import scan_views

    p = (1 + 5 ** 0.5) / 2
    v = np.array([(-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p), (0, 1, p),
                  (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1)])
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
         (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
         (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    path = tmp_path / "ico.obj"
    path.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v * 0.2)
                    + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
    scans = {d.type: scan_views(str(path), 4, 48, 20000, device=d)
             for d in (cuda, torch.device("cpu"))}
    from scipy.spatial import cKDTree
    dist, _ = cKDTree(scans["cpu"]).query(scans["cuda"])
    assert abs(len(scans["cuda"]) - len(scans["cpu"])) <= 0.01 * len(scans["cpu"])
    assert np.mean(dist <= 1e-5) >= 0.99
    b2 = _b2()
    vox = filters.voxel_downsample(make_cloud(scans["cuda"], device=cuda), 0.01)
    assert _b2() - b2 == 1
    vox = vox.take(torch.nonzero(vox.mask)[:, 0])
    rng = np.random.default_rng(12)
    s = rng.normal(size=(50000, 3))
    r = 0.2 * np.sqrt(1 + p * p)                     # the icosahedron's circumradius
    surf = torch.as_tensor((r * s / np.linalg.norm(s, axis=1, keepdims=True))
                           .astype(np.float32), device=cuda)
    m = torch.ones(len(surf), dtype=torch.bool, device=cuda)
    b1 = _b1()
    idx, d2 = bruteforce.nn1(surf, m, vox.xyz)
    assert _b1() - b1 == 1
    ip, dp = nn1_mod.nn1_plain(surf, m, vox.xyz)
    assert torch.equal(idx, ip) and torch.equal(d2, dp)


def test_render_depth_and_organized_edges_on_card_match_cpu(cuda):
    """Path P's (c) and (d) at a small size: the z-buffer on the card equals
    the CPU run's but where a point lies within 1e-4 px of a half pixel; the
    organized edges' labels are equal; the likelihoods agree to 1e-5 of the
    sum of their terms' magnitudes."""
    from pcl_tpu_torch import simulation
    from pcl_tpu_torch.features import organized_edge
    from pcl_tpu_torch.fusion import Intrinsics

    rng = np.random.default_rng(13)
    H, W = 48, 64
    intr = Intrinsics(60.0, 60.0, 31.5, 23.5)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    z = np.where((u > 20) & (u < 40) & (v > 10) & (v < 30), 1.5, 3.0)
    z = z + rng.normal(scale=0.002, size=z.shape)
    z[rng.random(z.shape) < 0.03] = 0.0
    xyz = np.stack([(u - intr.cx) / intr.fx * z, (v - intr.cy) / intr.fy * z, z], -1)
    xyz = xyz.astype(np.float32).reshape(-1, 3)
    valid = z.reshape(-1) > 0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.02, 0.0, -0.02)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        c = make_cloud(xyz, valid, width=W, height=H, device=dev)
        r = simulation.render_depth(make_cloud(xyz[valid], device=dev),
                                    torch.as_tensor(pose, device=dev), intr, H, W)
        ll = float(simulation.range_likelihood(r, torch.as_tensor(z.astype(np.float32),
                                                                  device=dev)))
        out[dev.type] = (organized_edge.organized_edge_detection(c, edge_types=7).cpu().numpy(),
                         r.cpu().numpy(), ll)
    (la, ra, lla), (lb, rb, llb) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(la, lb)
    assert ((la & 6) > 0).sum() > 50
    assert np.mean(ra == rb) >= 0.99
    assert abs(lla - llb) <= 1e-5 * H * W * 10


def test_grabbers_make_cuda_clouds_equal_to_the_cpu_run(cuda, tmp_path):
    """The Velodyne, image and TiM grabbers and the compressed-cloud decoder
    place their clouds on the card unless told otherwise, and hold the CPU
    run's points bit for bit (the host decodes; the vertex map's product and
    quotient round once each on either device)."""
    from pcl_tpu_torch.io import compression, grabber, tim, velodyne

    rng = np.random.default_rng(60)
    pkts = [velodyne.encode_packet(np.arange(12) * 0.4 + 12 * 0.4 * p,
                                   rng.uniform(1, 50, (12, 32)), rng.integers(0, 256, (12, 32)))
            for p in range(40)]
    pcap = str(tmp_path / "c.pcap")
    velodyne.write_pcap(pcap, pkts)
    for model in ("VLP16", "HDL32E"):
        a = list(velodyne.PcapVelodyneGrabber(pcap, model).frames())
        b = list(velodyne.PcapVelodyneGrabber(pcap, model, device="cpu").frames())
        assert len(a) == len(b) == 1 and a[0].xyz.is_cuda and a[0].attrs["intensity"].is_cuda
        assert torch.equal(a[0].xyz.cpu(), b[0].xyz)
    z = rng.uniform(0.5, 4.0, size=(48, 64)).astype(np.float32)
    z[rng.random(z.shape) < 0.1] = 0.0
    np.save(str(tmp_path / "d.npy"), z)
    a = next(grabber.ImageGrabber(str(tmp_path), 50.0).frames())
    b = next(grabber.ImageGrabber(str(tmp_path), 50.0, device="cpu").frames())
    assert a.xyz.is_cuda and (a.width, a.height) == (64, 48)
    assert torch.equal(a.xyz.cpu(), b.xyz) and torch.equal(a.mask.cpu(), b.mask)
    log = tmp_path / "tim.log"
    log.write_text("sRA LMDscandata " + "0 " * 23 + "3 3E8 7D0 BB8")
    a = next(tim.TimGrabber(str(log)).frames())
    assert a.xyz.is_cuda and torch.equal(a.xyz.cpu(), next(
        tim.TimGrabber(str(log), device="cpu").frames()).xyz)
    xyz = rng.normal(size=(5000, 3)).astype(np.float32)
    blob = compression.compress_cloud(make_cloud(xyz), 0.05)
    assert blob == compression.compress_cloud(make_cloud(xyz, device="cpu"), 0.05)
    a = compression.decompress_cloud(blob)
    assert a.xyz.is_cuda and torch.equal(a.xyz.cpu(),
                                         compression.decompress_cloud(blob, device="cpu").xyz)


def test_brute_icp_on_voxel_grids_launches_b1(cuda):
    """A voxel grid's xyz is a column slice of its sums (not contiguous):
    the brute ICP on two grids hands B1 contiguous copies and launches it
    once an iteration, as on the CPU run (path Q's small front end)."""
    rng = np.random.default_rng(61)
    g = rng.uniform(-3, 3, size=(6000, 2))
    tgt = np.c_[g, 0.3 * np.sin(g[:, 0])].astype(np.float32)
    src = (tgt + [0.05, -0.02, 0.01]).astype(np.float32)
    vs, vt = (filters.voxel_downsample(make_cloud(a), 0.1) for a in (src, tgt))
    assert not vs.xyz.is_contiguous()
    before = _b1()
    res = icp(vs, vt, max_corr_dist=float("inf"), max_iterations=5)
    torch.cuda.synchronize()
    assert _b1() - before == int(res.iterations)
    cpu = icp(*(filters.voxel_downsample(make_cloud(a, device="cpu"), 0.1) for a in (src, tgt)),
              max_corr_dist=float("inf"), max_iterations=5)
    assert torch.allclose(res.transform.cpu(), cpu.transform, atol=1e-5)


def test_f8_casts_on_the_card(cuda):
    """F8: torch's own cast of values beyond the int32 range on the card
    (printed: it was never measured before), and ``xla_int32`` of the same,
    which saturates and takes NaN to 0 as on the CPU."""
    from pcl_tpu_torch.core.casts import xla_int32

    x = torch.tensor([3e9, -3e9, float("nan"), 1e20])
    print(f"card: {x.to(cuda).to(torch.int32).cpu().tolist()}, CPU: {x.to(torch.int32).tolist()}")
    want = [2147483647, -2147483648, 0, 2147483647]
    assert xla_int32(x.to(cuda)).cpu().tolist() == xla_int32(x).tolist() == want


@pytest.mark.parametrize("far", [3e9, -3e9, 1e20])
def test_voxel_grid_far_away_launches_b2_and_matches_cpu(cuda, far):
    """F8 on the card: one valid point far out among 64 near ones; the
    voxels of the card (B2, once) equal the CPU run's."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-5, 5, (65, 3)).astype(np.float32)
    xyz[64] = [far, 0.0, 0.0]
    before = _b2()
    card = filters.voxel_downsample(make_cloud(xyz, device=cuda), 0.5)
    cpu = filters.voxel_downsample(make_cloud(xyz, device="cpu"), 0.5)
    assert _b2() == before + 1
    assert torch.equal(card.mask.cpu(), cpu.mask)
    torch.testing.assert_close(card.xyz.cpu(), cpu.xyz, rtol=1e-6, atol=1e-5)


def test_native_kdtree_1nn_matches_b1(cuda):
    """The native host kd-tree (built from ``csrc/pcl_native.cpp`` by the
    host's compiler) against B1 on a 20,000-point cloud: indices equal off
    near-ties, squared distances within 1e-6 of ``q^2 + t^2``."""
    from pcl_tpu_torch import native

    assert native.available()
    rng = np.random.default_rng(1)
    t = rng.uniform(-50, 50, (20000, 3)).astype(np.float32)
    q = rng.uniform(-50, 50, (20000, 3)).astype(np.float32)
    d2, ii = native.KdTree(t).knn(q, 1)
    tc, qc = torch.from_numpy(t).to(cuda), torch.from_numpy(q).to(cuda)
    ik, dk = (x.cpu().numpy() for x in nn1_mod.nn1(tc, torch.ones(len(t), dtype=torch.bool,
                                                                  device=cuda), qc))
    scale = (q.astype(np.float64) ** 2).sum(1) + (t[ik].astype(np.float64) ** 2).sum(1)
    miss = ii[:, 0] != ik
    if miss.any():
        da = ((q[miss] - t[ii[miss, 0]]).astype(np.float64) ** 2).sum(1)
        db = ((q[miss] - t[ik[miss]]).astype(np.float64) ** 2).sum(1)
        assert (np.abs(da - db) <= 1e-6 * scale[miss]).all()
    assert (np.abs(d2[:, 0] - dk) <= 1e-6 * scale).all()
