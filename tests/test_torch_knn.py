"""Parity of pcl_tpu_torch's neighbourhood searches with pcl_tpu.search on the
CPU: brute-force kNN and radius search, the cell list's kNN, radius search
and radius count (with hash collisions between offsets and with overflowing
buckets), the unified dispatch, the host density probe and the organized
window search.

Tolerances. The brute force computes the matmul-identity distance on both
sides, from matrix products that round differently: distances agree to
1e-6 of q^2 + t^2 (here <= 6). The cell list and the organized search take
differences on both sides: 1e-6 relative. Indices are compared exactly
except where two listed distances lie within that tolerance of each other
(the JAX package's bitonic tournament is not a stable sort, so exact ties may
come in another order); the inputs hold no duplicated points.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcl_tpu.search as jsearch
from pcl_tpu.core.cloud import Cloud as JCloud
from pcl_tpu.search import bruteforce as jbf
from pcl_tpu.search import cell_list as jcl
from pcl_tpu.search import organized as jorg

import pcl_tpu_torch.search as tsearch
from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.search import bruteforce as tbf
from pcl_tpu_torch.search import cell_list as tcl
from pcl_tpu_torch.search import organized as torg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_lists(got, want, atol, rtol=0.0, min_exact=0.9):
    """(idx, d2, valid, ...) lists: validity exact, d2 close, indices equal
    away from near-ties (at least ``min_exact`` of the valid entries);
    trailing outputs (count, truncated) exact."""
    gi, gd, gv = (_np(x) for x in got[:3])
    wi, wd, wv = (_np(x) for x in want[:3])
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gd[gv], wd[wv], rtol=rtol, atol=atol)
    assert np.all(np.isinf(gd[~gv]))
    tol = atol + rtol * np.abs(np.where(wv, wd, 0.0))
    near = np.zeros_like(gv)
    gap = np.abs(np.diff(np.where(wv, wd, 1e30), axis=1)) <= tol[:, 1:]
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    ok = gv & ~near
    np.testing.assert_array_equal(gi[ok], wi[ok])
    assert ok.sum() >= min_exact * gv.sum()
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(_np(g), _np(w))


def _points(rng, n, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_bruteforce_knn(rng, k):
    t, q = _points(rng, 700), _points(rng, 300)
    m = rng.random(700) < 0.9
    if k == 64:
        m[:] = False
        m[:40] = True           # fewer valid targets than k: padded
    want = jbf.knn(jnp.asarray(t), jnp.asarray(m), jnp.asarray(q), k, chunk=128)
    got = tbf.knn(torch.from_numpy(t), torch.from_numpy(m), torch.from_numpy(q), k, chunk=128)
    assert got[0].dtype == torch.int32 and got[0].shape == (300, k)
    _same_lists(got, want, atol=6e-6)


def test_bruteforce_knn_more_than_targets(rng):
    t, q = _points(rng, 5), _points(rng, 20)
    m = np.ones(5, bool)
    want = jbf.knn(jnp.asarray(t), jnp.asarray(m), jnp.asarray(q), 8)
    got = tbf.knn(torch.from_numpy(t), torch.from_numpy(m), torch.from_numpy(q), 8)
    _same_lists(got, want, atol=6e-6)
    assert not got[2][:, 5:].any()


def test_smallest_k_keeps_k_columns_only():
    """The k smallest are copies: a view of the sorted rows would keep every
    query chunk's whole ``[chunk, M]`` sort alive (the brute k-NN of 70k
    points held 60 GB that way)."""
    d = torch.rand(64, 5000)
    dd, col = tbf.smallest_k(d, 8)
    assert dd.untyped_storage().nbytes() == 64 * 8 * 4
    assert col.untyped_storage().nbytes() == 64 * 8 * 8


@pytest.mark.parametrize("r,cap", [(0.3, 16), (0.6, 8)])
def test_bruteforce_radius(rng, r, cap):
    t, q = _points(rng, 800), _points(rng, 250)
    m = rng.random(800) < 0.9
    want = jbf.radius(jnp.asarray(t), jnp.asarray(m), jnp.asarray(q), r, cap, chunk=128)
    got = tbf.radius(torch.from_numpy(t), torch.from_numpy(m), torch.from_numpy(q), r, cap,
                     chunk=128)
    _same_lists(got, want, atol=6e-6)
    if r == 0.6:
        assert (got[3] > cap).any()         # the true count exceeds the cap


def _tables(rng, n=1500, cell=0.25, **kw):
    xyz = _points(rng, n)
    mask = rng.random(n) < 0.9
    j = jcl.build(jnp.asarray(xyz), jnp.asarray(mask), jnp.float32(cell), **kw)
    t = tcl.build(torch.from_numpy(xyz), torch.from_numpy(mask), np.float32(cell), **kw)
    return xyz, mask, j, t


TABLES = [
    ("hash", dict(table_size=1 << 12, cap=64)),
    ("dedup", dict(table_size=7, cap=256)),             # offsets collide in 7 buckets
    ("truncated", dict(table_size=1 << 12, cap=4)),
    ("dense", dict(dims=(9, 9, 9), cap=64)),
]


# k = 16 takes the JAX package's tournament, 10 its sort; 2048 is more than
# the 27 * 4 candidates of the small table (padded lists)
KNN_CASES = [(name, spec, k) for name, spec in TABLES for k in (16, 10)] + \
    [("truncated", TABLES[2][1], 2048)]


@pytest.mark.parametrize("name,spec,k", KNN_CASES,
                         ids=[f"{c[0]}-k{c[2]}" for c in KNN_CASES])
def test_cell_knn_radius(rng, name, spec, k):
    xyz, mask, jt, tt = _tables(rng, **spec)
    q = np.concatenate([xyz[:200], _points(rng, 100)])
    want = jcl.knn_radius(jt, jnp.asarray(q), k)
    got = tcl.knn_radius(tt, torch.from_numpy(q), k)
    _same_lists(got, want, atol=1e-7, rtol=1e-6)
    assert bool(got[3].any()) == (name == "truncated")


@pytest.mark.parametrize("name,spec", TABLES, ids=[x[0] for x in TABLES])
def test_cell_radius_search_and_count(rng, name, spec):
    xyz, mask, jt, tt = _tables(rng, **spec)
    q = np.concatenate([xyz[:200], _points(rng, 100)])
    r = 0.2
    want = jcl.radius_search(jt, jnp.asarray(q), r, cap_out=24)
    got = tcl.radius_search(tt, torch.from_numpy(q), r, cap_out=24)
    _same_lists(got, want, atol=1e-7, rtol=1e-6)
    wc, wtr = jcl.radius_count(jt, jnp.asarray(q), r)
    gc, gtr = tcl.radius_count(tt, torch.from_numpy(q), r)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gtr.numpy(), np.asarray(wtr))
    if name != "truncated":         # the count of the list equals the true count
        np.testing.assert_array_equal(got[3].numpy(), gc.numpy())


def test_cell_knn_with_radius_gate(rng):
    _, _, jt, tt = _tables(rng, table_size=1 << 12, cap=64)
    q = _points(rng, 200)
    want = jcl.knn_radius(jt, jnp.asarray(q), 8, r=0.1)
    got = tcl.knn_radius(tt, torch.from_numpy(q), 8, r=0.1)
    _same_lists(got, want, atol=1e-7, rtol=1e-6)
    assert not got[2].all()             # the gate leaves short lists


@pytest.mark.parametrize("search", ["knn_radius", "radius_search", "radius_count"])
def test_cell_searches_in_query_chunks(rng, monkeypatch, search):
    """Queries are independent: chunks of 7 queries (``_CHUNK_SLOTS``) give
    exactly the one-chunk result, including the truncation flags."""
    xyz, _, _, tt = _tables(rng, table_size=1 << 12, cap=4)
    q = torch.from_numpy(np.concatenate([xyz[:60], _points(rng, 40)]))
    run = {"knn_radius": lambda: tcl.knn_radius(tt, q, 10),
           "radius_search": lambda: tcl.radius_search(tt, q, 0.2, cap_out=24),
           "radius_count": lambda: tcl.radius_count(tt, q, 0.2)}[search]
    whole = run()
    monkeypatch.setattr(tcl, "_CHUNK_SLOTS", 27 * tt.cap * 7)
    chunked = run()
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)
    assert bool(whole[-1].any())        # cap 4 truncates some queries


def _clouds(rng, n=1200):
    xyz = _points(rng, n)
    mask = rng.random(n) < 0.9
    xyz[~mask] = 0.0
    return (JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
            Cloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask)))


DISPATCH = [
    ("bruteforce", dict(backend="bruteforce"), 6e-6, 0.0),
    ("cell_sized", dict(backend="cell", cell_size=0.3, cell_cap=64), 1e-7, 1e-6),
    ("cell_density", dict(backend="cell", cell_cap=96), 1e-7, 1e-6),
    ("auto_big", dict(cell_size=0.3, cell_cap=64), 1e-7, 1e-6),
]


@pytest.mark.parametrize("name,kw,atol,rtol", DISPATCH, ids=[x[0] for x in DISPATCH])
def test_search_knn_dispatch(rng, monkeypatch, name, kw, atol, rtol):
    jc, tc = _clouds(rng)
    q = _points(rng, 400)
    if name == "auto_big":      # 1200 x 400 pairs pass a lowered threshold
        monkeypatch.setattr(jsearch, "_AUTO_PAIRS", 1e5)
        monkeypatch.setattr(tsearch, "_AUTO_PAIRS", 1e5)
    want = jsearch.knn(jc, jnp.asarray(q), 12, return_trunc=True, **kw)
    got = tsearch.knn(tc, torch.from_numpy(q), 12, return_trunc=True, **kw)
    _same_lists(got, want, atol=atol, rtol=rtol)
    assert len(tsearch.knn(tc, torch.from_numpy(q), 12, **kw)) == 3


def test_search_radius_and_nn1(rng):
    jc, tc = _clouds(rng)
    q = _points(rng, 300)
    for kw, atol, rtol in ((dict(backend="bruteforce"), 6e-6, 0.0),
                           (dict(backend="cell", cell_cap=64), 1e-7, 1e-6)):
        want = jsearch.radius_search(jc, jnp.asarray(q), 0.25, 16, return_trunc=True, **kw)
        got = tsearch.radius_search(tc, torch.from_numpy(q), 0.25, 16, return_trunc=True, **kw)
        _same_lists(got, want, atol=atol, rtol=rtol)
    # nn1: the port's exact distance against the JAX CPU path's matmul
    # identity (ROADMAP C1), so distances to 1e-6 of their scale
    wi, wd = jsearch.nn1(jc, jnp.asarray(q))
    gi, gd = tsearch.nn1(tc, torch.from_numpy(q))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=6e-6)


def test_hashgrid_backend_not_ported(rng):
    """The name is older than the port of the hash grid: ``backend="hashgrid"``
    now dispatches to it as the JAX package does (kNN needs ``cell_size``;
    radius search takes cells ``r`` wide). Distances are differences on both
    sides: 1e-6 relative."""
    jc, tc = _clouds(rng, n=400)
    q = _points(rng, 120)
    want = jsearch.knn(jc, jnp.asarray(q), 6, backend="hashgrid", cell_size=0.3,
                       return_trunc=True, bucket_cap=16)
    got = tsearch.knn(tc, torch.from_numpy(q), 6, backend="hashgrid", cell_size=0.3,
                      return_trunc=True, bucket_cap=16)
    _same_lists(got, want, atol=1e-7, rtol=1e-6)
    want = jsearch.radius_search(jc, jnp.asarray(q), 0.3, 8, backend="hashgrid",
                                 return_trunc=True)
    got = tsearch.radius_search(tc, torch.from_numpy(q), 0.3, 8, backend="hashgrid",
                                return_trunc=True)
    _same_lists(got, want, atol=1e-7, rtol=1e-6)
    with pytest.raises(ValueError, match="requires cell_size"):
        tsearch.knn(tc, tc.xyz, 4, backend="hashgrid")


def _surface(rng, n=3000):
    """Points on two walls and a floor with a little noise: a surface cloud,
    as the probe is meant for."""
    u, v = rng.uniform(0, 4, size=(2, n)).astype(np.float32)
    side = rng.integers(0, 3, n)
    xyz = np.where(side[:, None] == 0, np.stack([u, v, 0 * u], 1),
                   np.where(side[:, None] == 1, np.stack([u, 0 * u, v], 1),
                            np.stack([0 * u, u, v], 1)))
    return (xyz + rng.normal(scale=0.003, size=xyz.shape)).astype(np.float32)


@pytest.mark.parametrize("cell_size", [None, 0.3])
def test_auto_cell_params_equal(rng, cell_size):
    xyz = _surface(rng)
    mask = rng.random(len(xyz)) < 0.95
    jc = JCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask))
    tc = Cloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask))
    assert tsearch.auto_cell_params(tc, 16, cell_size) == \
        jsearch.auto_cell_params(jc, 16, cell_size)
    assert tsearch.auto_cell_params(tc, 16, cell_size, limit=32) == \
        jsearch.auto_cell_params(jc, 16, cell_size, limit=32)
    assert tsearch.auto_cell_cap(tc, 16, cell_size) == jsearch.auto_cell_cap(jc, 16, cell_size)
    assert tsearch.auto_cell_params(tc.xyz[:10], 16) == jsearch.auto_cell_params(
        jnp.asarray(xyz[:10]), 16)
    want = float(jsearch.knn_density_radius(jc.xyz, jc.mask, 16))
    got = float(tsearch.knn_density_radius(tc.xyz, tc.mask, 16))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("table_size", [1 << 17, 64, 7])
def test_auto_cell_params_cap_holds_on_the_hashed_table(rng, monkeypatch, table_size):
    """The probed cap is measured on the table the search builds: in a small
    table many cells share a bucket, and the cap still holds the fullest one
    (the JAX package's probe counts cells and would report 48 throughout)."""
    xyz = _surface(rng)
    tc = Cloud(xyz=torch.from_numpy(xyz), mask=torch.ones(len(xyz), dtype=torch.bool))
    sparse = tsearch.auto_cell_params(tc, 16)[1]
    monkeypatch.setattr(tsearch, "_TABLE_SIZE", table_size)
    cell, cap = tsearch.auto_cell_params(tc, 16, limit=1 << 14)
    table = tcl.build(tc.xyz, tc.mask, np.float32(cell), table_size=table_size, cap=cap)
    fullest = int(table.count[:-1].max())
    assert cap // 2 < max(fullest, 24) <= cap
    assert cap == tsearch.auto_cell_cap(tc, 16, cell, limit=1 << 14)
    *_, trunc = tsearch.knn(tc, tc.xyz[::10], 16, backend="cell", cell_size=cell, cell_cap=cap,
                            table_size=table_size, return_trunc=True)
    assert not bool(trunc.any())
    if table_size < 1 << 17:
        assert cap > sparse


def _organized(H=24, W=32, seed=0):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    z = 2.0 + 0.05 * np.sin(yy * 0.3) + 0.04 * np.cos(xx * 0.2)
    xyz = np.stack([(xx - W / 2) * 0.01 * z, (yy - H / 2) * 0.01 * z, z],
                   axis=-1).astype(np.float32)
    valid = np.random.default_rng(seed).random((H, W)) > 0.05
    return xyz, valid


@pytest.mark.parametrize("k,window", [(9, 9), (16, 5)])
def test_organized_self_knn(k, window):
    xyz, valid = _organized()
    want = jorg.self_knn(jnp.asarray(xyz), jnp.asarray(valid), k, window=window)
    got = torg.self_knn(torch.from_numpy(xyz), torch.from_numpy(valid), k, window=window)
    _same_lists(got, want, atol=1e-9, rtol=1e-6)


def test_organized_knn_and_radius(rng):
    xyz, valid = _organized()
    js = jorg.build(xyz, valid)
    ts = torg.build(torch.from_numpy(xyz), torch.from_numpy(valid))
    np.testing.assert_array_equal(ts.P.numpy(), np.asarray(js.P))
    q = xyz[valid][::7] + rng.normal(scale=0.002, size=(int(valid.sum() + 6) // 7, 3)).astype(np.float32)
    # windows clamped at the image border repeat a pixel: exact ties, which
    # the comparison skips
    _same_lists(torg.knn(ts, torch.from_numpy(q), 6), jorg.knn(js, jnp.asarray(q), 6),
                atol=1e-9, rtol=1e-6, min_exact=0.5)
    _same_lists(torg.radius(ts, torch.from_numpy(q), 0.03, 12),
                jorg.radius(js, jnp.asarray(q), 0.03, 12), atol=1e-9, rtol=1e-6,
                min_exact=0.5)
