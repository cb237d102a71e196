"""The harness's shared parts: a run's files found by name, the spans, the
profiler's trace reduced to busy time, the device's top operations and idle
gaps, and the comparison lines.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its files are found
by the names there: ``benchmark/configs/<config>.json`` (the deployment),
``benchmark/traffic/<traffic>.json`` (the traffic: the generator's parameters
and the per-unit settings, which name the driver ``benchmark/drivers/<driver>.py``)
and ``benchmark/cells/<name>.json`` (what the correctness check samples and
the limits of the numbers it compares). A metric is read by
``benchmark/metrics/<name>.py``. Adding a cell, a configuration or a metric
adds files; no file here names one.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
SPAN_PREFIX = "bench."


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module loaded from its file (names may hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(f"bench_{name}".replace(".", "_").replace("-", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_of(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    """Whether ``metric`` is read in ``cell``: its ``workloads`` list where it
    has one; without it, an end-to-end metric in every cell and a per-layer
    metric in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if reported is not None and "moves" in metric:
        return metric["moves"] in reported
    return True


class Run:
    """One run of one cell: its files, its arguments, its spans and units."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device: str,
                 root: Path = ROOT, overrides: Optional[dict] = None):
        self.spec = spec_of(root)
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.workload = found[0]
        bench = root / "benchmark"
        self.config = load_json(bench / "configs" / f"{self.workload['config']}.json")
        self.traffic = load_json(bench / "traffic" / f"{self.workload['traffic']}.json")
        self.cell = load_json(bench / "cells" / f"{name}.json")
        for part, values in (overrides or {}).items():
            getattr(self, part).update(values)
        self.bench = bench
        self.name = name
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.tracing = bool(trace)
        self.device = device
        self.spans: List[tuple] = []          # (name, unit, t0, t1) on the host clock
        self.units: List[dict] = []
        self.unit_index = -1
        self.trace: Optional[Trace] = None
        self.setup_s = math.nan
        self.window_s = math.nan

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        """A span around a call into one of the port's layers: the card
        synchronised at both ends and the interval recorded on the host clock
        and, under the profiler, as an annotation. Only in a traced run."""
        if not self.tracing:
            yield
            return
        import torch

        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            yield
            self.sync()
        self.spans.append((name, self.unit_index, t0, time.perf_counter()))

    def span_ms(self, name: str) -> Optional[float]:
        """Mean milliseconds a counted unit spent in ``name`` spans (0 for a
        counted unit without one), or None where no unit had one."""
        counted = {i for i, u in enumerate(self.units) if u.get("counted")}
        if not counted:
            return None
        total, seen = 0.0, False
        for n, unit, t0, t1 in self.spans:
            if n == name and unit in counted:
                total += t1 - t0
                seen = True
        return total * 1e3 / len(counted) if seen else None


class Trace:
    """The profiler's events over the traced units: device intervals
    (kernels, copies, sets) and the benchmark's span annotations, both in the
    profiler's nanoseconds."""

    def __init__(self, prof):
        import torch

        events = prof.profiler.kineto_results.events()
        self.device_ops = []
        self.annotations = []
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.name().startswith(SPAN_PREFIX):
                # an annotation: the host's range (the profiler also repeats it
                # on the device's timeline, over the kernels it launched)
                if e.device_type() == torch.autograd.DeviceType.CPU:
                    self.annotations.append((e.name()[len(SPAN_PREFIX):], start, start + dur))
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                self.device_ops.append((start, start + dur, e.name()[:160]))
        units = [(s, t) for n, s, t in self.annotations if n == "unit"]
        self.t0 = min(s for s, _ in units) if units else 0
        self.t1 = max(t for _, t in units) if units else 0
        self.merged = self._merge([(max(s, self.t0), min(t, self.t1))
                                   for s, t, _ in self.device_ops if t > self.t0 and s < self.t1])

    @staticmethod
    def _merge(iv):
        out = []
        for s, t in sorted(iv):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.merged) / 1e9

    def top_ops(self, n: int = 10):
        by = {}
        for s, t, name in self.device_ops:
            if t > self.t0 and s < self.t1:
                by[name] = by.get(name, 0.0) + (t - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The device's idle time in the traced window, summed by the
        innermost benchmark span open at each gap's midpoint."""
        gaps = []
        prev = self.t0
        for s, t in self.merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        inner = sorted(self.annotations, key=lambda a: a[2] - a[1])
        by = {}
        for a, b in gaps:
            mid = (a + b) / 2
            label = next((nm for nm, s, t in inner if s <= mid <= t), "between units")
            by[label] = by.get(label, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def finite(v: float) -> float:
    """A number JSON can carry: a non-finite reading becomes 1e30."""
    return v if math.isfinite(v) else 1e30


def check_lines(checks: Dict[str, tuple]) -> List[str]:
    return [f"check {k}: {finite(v):.9g} against its limit {lim:.9g} "
            f"{'ok' if finite(v) <= lim else 'FAILED'}" for k, (v, lim) in checks.items()]
