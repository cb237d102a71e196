"""``benchmark/port_trace.py``: its trace keeps the port's annotations apart
from the device's operations, reads busy and idle time under the port's
spans, labels idle gaps by the innermost span, and a CPU run at the small
size prints the readings of the port's counters and spans."""

import contextlib
import io
import json
from types import SimpleNamespace

import pytest
import torch

from small import CHECK, DRIVE, ROOT, SENSOR, TRACE_UNITS

from benchmark import harness, port_trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._d, self._t = name, start, end - start, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


# one unit from 0 to 1000 ns: kernels at 100-200, 300-400 and 600-900; the
# port's span "a" on the host over 50-500 (its device side 100-400) holding
# "b" over 250-450 (device side 300-400); "c" on the host over 550-950
EVENTS = [
    Event("bench.unit", 0, 1000, CPU), Event("bench.unit", 0, 1000, CUDA),
    Event("k1", 100, 200, CUDA), Event("k2", 300, 400, CUDA), Event("k3", 600, 900, CUDA),
    Event("aten::add", 100, 110, CPU),
    Event("pcl.a", 50, 500, CPU), Event("pcl.a", 100, 400, CUDA),
    Event("pcl.b", 250, 450, CPU), Event("pcl.b", 300, 400, CUDA),
    Event("pcl.c", 550, 950, CPU), Event("pcl.c", 600, 900, CUDA),
]


def test_port_annotations_are_not_device_operations():
    base = harness.Trace(_prof([e for e in EVENTS if not e.name().startswith("pcl.")]))
    tr = port_trace.PortTrace(_prof(EVENTS))
    assert sorted(n for _, _, n in tr.device_ops) == ["k1", "k2", "k3"]
    assert tr.busy_s == base.busy_s == pytest.approx(500e-9)
    assert tr.window_s == pytest.approx(1000e-9)
    assert sorted(tr.port_spans) == [("a", 50, 500), ("b", 250, 450), ("c", 550, 950)]
    assert sorted(tr.port_device_spans) == [("a", 100, 400), ("b", 300, 400), ("c", 600, 900)]
    # the harness alone would count the device-side repeats as operations
    assert harness.Trace(_prof(EVENTS)).busy_s > tr.busy_s


def test_busy_and_idle_under_the_ports_spans():
    tr = port_trace.PortTrace(_prof(EVENTS))
    assert tr.busy_under(["a"]) == pytest.approx(200e-9)
    assert tr.busy_under(["b"]) == pytest.approx(100e-9)
    assert tr.busy_under(["a", "c"]) == pytest.approx(500e-9)
    assert tr.busy_in_annotation("unit") == pytest.approx(500e-9)
    # gaps 0-100 (mid 50), 200-300 (250), 400-600 (500), 900-1000 (950)
    assert tr.idle_under(["a"]) == pytest.approx(400e-9)
    assert tr.idle_under(["b"]) == pytest.approx(100e-9)
    assert tr.idle_under(["c"]) == pytest.approx(100e-9)


def test_idle_gaps_are_labelled_by_the_innermost_span():
    tr = port_trace.PortTrace(_prof(EVENTS))
    assert dict(tr.idle_gaps()) == pytest.approx({"a": 300e-9, "b": 100e-9, "c": 100e-9})


def test_without_port_events_the_trace_reads_as_the_harness():
    events = [e for e in EVENTS if not e.name().startswith("pcl.")]
    base, tr = harness.Trace(_prof(events)), port_trace.PortTrace(_prof(events))
    assert tr.busy_s == base.busy_s and tr.window_s == base.window_s
    assert tr.idle_gaps() == base.idle_gaps() and tr.top_ops() == base.top_ops()


def test_a_small_cpu_run_reads_the_ports_counters_and_spans():
    spec = harness.spec_of(ROOT)
    wl = next(w for w in spec["workloads"] if w["name"] == "odom-gicp")
    bench = ROOT / "benchmark"
    cfg = harness.load_json(bench / "configs" / f"{wl['config']}.json")
    tr = harness.load_json(bench / "traffic" / f"{wl['traffic']}.json")
    over = {"config": {"sensor": dict(cfg["sensor"], **SENSOR)},
            "traffic": {"drive": dict(tr["drive"], **DRIVE), "trace_units": TRACE_UNITS},
            "cell": {"check": dict(CHECK)}}
    argv = ["--workload", "odom-gicp", "--seed", "2147483999", "--seconds", "2",
            "--trace", "1"]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_trace.main(argv, device="cpu", overrides=over)
    assert rc == 0, err.getvalue()[-3000:]
    lines = out.getvalue().strip().splitlines()
    result, port = json.loads(lines[-2]), json.loads(lines[-1])
    assert result["correct"], err.getvalue()[-3000:]
    r = port["port_readings"]
    # the device's readings need a card's trace; the rest are read here
    assert not {"cov_ms", "corr_ms", "solve_ms", "iter_idle_ms"} & set(r)
    # a scan: the voxel grid's test, two host copies in each of the five
    # probes, one read-back an iteration, and the copies from host memory
    its = result["metrics"]["iterations.odom"]["value"]
    sites = r["readbacks_by_site"]
    assert sites["sync.voxel_dense_test"] == 1 and sites["sync.leaf_size"] == 1
    assert r["probe_calls"] == 5
    assert sites["sync.host_points"] == 2 * r["probe_calls"]
    assert sites["sync.gicp_converged"] == its
    assert sites["sync.gicp_iterations"] == 1 and sites["sync.cov_diag"] == 2
    assert sites["sync.cell_offsets"] >= its
    assert r["readbacks"] == sum(sites.values())
    # under 32,768 points the covariances take the brute k-NN, not the cell list
    assert r["knn_slots"] == 0
    assert all(c % 24 == 0 for c in r["corr_cap"])
    assert 0 < r["row_use"] < 1
    assert r["readback_wait_ms"] >= 0
