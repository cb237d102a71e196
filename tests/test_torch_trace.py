"""The port's recorder (``pcl_tpu_torch.utils.trace``): spans, counters and
read-backs, off and on, and what GICP's cell path records in it."""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.core.transforms import se3_exp
from pcl_tpu_torch.ops import nn1 as nn1_mod
from pcl_tpu_torch.ops import segsum
from pcl_tpu_torch.utils import trace

tg = importlib.import_module("pcl_tpu_torch.registration.gicp")


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts from an empty recorder that is off, and leaves it so."""
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _names(spans):
    return [s[0] for s in spans]


def test_spans_record_nothing_while_off():
    with trace.span("a"):
        with trace.span("b"):
            pass
    assert trace.span("a") is trace.span("b")          # one shared no-op context
    assert trace.snapshot() == {"spans": [], "counters": {}}


def test_spans_nest_with_their_parents():
    trace.enable()
    with trace.span("outer"):
        with trace.span("first"):
            with trace.span("inner"):
                pass
        with trace.span("second"):
            pass
    with trace.span("after"):
        pass
    spans = trace.snapshot()["spans"]
    assert _names(spans) == ["outer", "first", "inner", "second", "after"]
    assert [s[1] for s in spans] == [-1, 0, 1, 0, -1]
    for name, parent, t0, t1 in spans:
        assert t0 <= t1
        if parent >= 0:
            assert spans[parent][2] <= t0 and t1 <= spans[parent][3]


def test_spans_lie_on_the_profilers_timeline():
    trace.enable()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            torch.ones(8).sum()
    assert "pcl.outer" in {e.name for e in prof.events()}


def test_host_counts_count_off_and_on():
    trace.count("n")
    trace.count("n", 4)
    trace.enable()
    trace.count("n", 2)
    assert trace.counts() == {"n": 7}
    assert trace.snapshot()["counters"] == {"n": 7}


def test_device_counts_count_only_while_on():
    trace.count("valid", torch.tensor(5))
    assert trace.snapshot()["counters"] == {}
    trace.enable()
    trace.count("valid", torch.tensor(5))
    trace.count("valid", torch.tensor(True))
    trace.count("valid", 2)                  # a host int adds to the same name
    assert trace.counts() == {"valid": 2}    # the device part is not read here
    assert trace.snapshot()["counters"] == {"valid": 8}


def test_readback_counts_off_and_spans_on():
    with trace.readback("site"):
        pass
    assert trace.snapshot() == {"spans": [], "counters": {"sync.site": 1}}
    trace.enable()
    with trace.span("outer"):
        with trace.readback("site"):
            pass
    snap = trace.snapshot()
    assert snap["counters"] == {"sync.site": 2}
    assert _names(snap["spans"]) == ["outer", "sync.site"]
    assert snap["spans"][1][1] == 0


def test_reset_forgets_everything():
    trace.enable()
    trace.count("n")
    trace.count("d", torch.tensor(3))
    with trace.span("a"):
        pass
    trace.reset()
    assert trace.enabled()
    assert trace.snapshot() == {"spans": [], "counters": {}}


def _padded_pair(capacity=2500, n=1800):
    """A cloud of two planes and a curved sheet, padded past its points as a
    voxel grid's output is, and the same cloud moved by a small motion."""
    rng = np.random.default_rng(3)
    n1 = n // 3
    a = np.stack([rng.uniform(-2, 2, n1), rng.uniform(-2, 2, n1), np.zeros(n1)], 1)
    b = np.stack([rng.uniform(-2, 2, n1), np.zeros(n1), rng.uniform(0, 2, n1)], 1)
    t = rng.uniform(-2, 2, size=(n - 2 * n1, 2))
    c = np.stack([t[:, 0], t[:, 1], 0.3 * np.sin(2 * t[:, 0]) + 1.5], 1)
    tgt = np.concatenate([a, b, c]).astype(np.float32)
    T = se3_exp(torch.tensor([0.05, -0.03, 0.04, 0.02, -0.015, 0.025])).numpy()
    src = ((tgt - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    return (make_cloud(src, capacity=capacity, device="cpu"),
            make_cloud(tgt, capacity=capacity, device="cpu"))


GICP_KW = dict(max_corr_dist=0.5, max_iterations=12, corr_backend="cell", cell_cap=96,
               cov_cell_size=0.6, cov_cell_cap=48)


def test_gicp_cell_path_records_its_parts():
    src, tgt = _padded_pair()
    trace.enable()
    res = tg.gicp(src, tgt, **GICP_KW)
    snap = trace.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    its = int(res.iterations)
    assert its >= 2
    assert _names(spans).count("gicp.covariances") == 2
    loops = [i for i, s in enumerate(spans) if s[0] == "gicp.iteration"]
    assert len(loops) == its
    for i in loops:
        assert sorted(s[0] for s in spans if s[1] == i) == \
            ["gicp.correspond", "gicp.solve", "sync.gicp_converged"]
    assert counters["sync.gicp_converged"] == its
    # the copies from host memory that wait for the stream: the covariances'
    # diagonal twice, three tables' cell sizes, the offsets once a search
    # (one chunk each here), the iteration count once
    assert counters["sync.cov_diag"] == 2
    assert counters["sync.cell_size"] == 3
    assert counters["sync.cell_offsets"] == 2 + its
    assert counters["sync.gicp_iterations"] == 1
    cap = src.capacity
    assert counters["cell_list.knn.slots"] == 2 * cap * 27 * GICP_KW["cov_cell_cap"]
    assert counters["cell_list.nn1.slots"] == its * cap * 8 * GICP_KW["cell_cap"]
    assert counters["cell_list.rows"] == (2 + its) * cap
    valid = int(src.mask.sum())
    assert valid < cap
    assert counters["cell_list.valid_rows"] == (2 + its) * valid


def test_gicp_result_is_the_same_with_the_recorder_on():
    src, tgt = _padded_pair()
    off = tg.gicp(src, tgt, **GICP_KW)
    trace.enable()
    on = tg.gicp(src, tgt, **GICP_KW)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_gicp_counts_without_the_recorder_only_host_ints():
    src, tgt = _padded_pair()
    res = tg.gicp(src, tgt, **GICP_KW)
    snap = trace.snapshot()
    assert snap["spans"] == []
    assert "cell_list.valid_rows" not in snap["counters"]
    assert snap["counters"]["sync.gicp_converged"] == int(res.iterations)


def test_cpu_kernel_calls_launch_nothing_and_chip_smoke_reads_the_recorder():
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    nn1_mod.nn1(t, torch.ones(50, dtype=torch.bool), t[:7])
    segsum.segment_sum_sorted(torch.ones(6, 2), torch.tensor([0, 0, 1, 1, 1, 6],
                                                             dtype=torch.int32))
    assert trace.counts() == {}
    assert chip_smoke.launch_count("nn1") == chip_smoke.launch_count("segsum") == 0
    trace.count("ops.nn1.launches", 3)
    trace.count("ops.segsum.launches")
    assert chip_smoke.launch_count("nn1") == 3
    assert chip_smoke.launch_count("segsum") == 1
    trace.reset()
    assert chip_smoke.launch_count("nn1") == chip_smoke.launch_count("segsum") == 0
