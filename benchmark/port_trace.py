#!/usr/bin/env python3
"""Run one cell of the benchmark with pcl_tpu_torch's own recorder on, and
print what the port's spans and counters read.

    python3 benchmark/port_trace.py --workload NAME --seed N --seconds S --trace 0|1
        [--recorder 0|1] [--sync-debug 0|1]

This is ``benchmark/run.py`` (its set-up, window, metrics, check and result
line, printed as it prints them) with two of the harness's parts replaced:

- ``PortRun`` clears the port's recorder (``pcl_tpu_torch.utils.trace``) as
  the window's first unit starts and turns it on there with ``--recorder 1``
  (the default); at the end of each unit it keeps the recorder's host
  counters, which reads nothing back. ``--sync-debug 1`` sets
  ``torch.cuda.set_sync_debug_mode("warn")`` over the window and counts each
  unit's warnings by the line that raised them.
- ``PortTrace`` keeps the port's ``pcl.`` annotations apart from the device's
  operations. The profiler repeats each annotation on the device's timeline
  over the kernels launched inside it; counted as an operation, such a range
  would fill the idle gaps it spans. Idle gaps are labelled by the innermost
  span open at their midpoint, the port's included.

After run.py's result line, one more JSON line gives the readings (see
:func:`readings`): those of the device trace need ``--trace 1``, those of
the port's spans ``--recorder 1``; the counters are read either way. A tree
without the recorder gives no readings but the sync-debug counts.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark import run as bench_run  # noqa: E402

PORT_PREFIX = "pcl."


def _recorder():
    try:
        from pcl_tpu_torch.utils import trace
    except ImportError:          # a tree from before the recorder
        return None
    return trace


class PortTrace(harness.Trace):
    """The harness's trace with the port's annotations kept apart:
    ``port_spans`` (the host's ranges) and ``port_device_spans`` (the
    profiler's repeat of each on the device's timeline), as ``(name, start,
    end)`` in the profiler's nanoseconds."""

    def __init__(self, prof):
        import torch

        super().__init__(prof)
        cpu = torch.autograd.DeviceType.CPU
        self.port_spans, self.port_device_spans = [], []
        for e in prof.profiler.kineto_results.events():
            if e.name().startswith(PORT_PREFIX):
                start = e.start_ns()
                (self.port_spans if e.device_type() == cpu else self.port_device_spans).append(
                    (e.name()[len(PORT_PREFIX):], start, start + e.duration_ns()))
        self.device_ops = [op for op in self.device_ops if not op[2].startswith(PORT_PREFIX)]
        self.merged = self._merge([(max(s, self.t0), min(t, self.t1))
                                   for s, t, _ in self.device_ops if t > self.t0 and s < self.t1])

    @staticmethod
    def _overlap(a, b) -> float:
        """Nanoseconds in both of two sorted lists of disjoint intervals."""
        total, i, j = 0, 0, 0
        while i < len(a) and j < len(b):
            lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
            total += max(0, hi - lo)
            if a[i][1] < b[j][1]:
                i += 1
            else:
                j += 1
        return total

    def busy_under(self, names) -> float:
        """Seconds of device operations (their union) inside the device-side
        ranges of the port's spans named ``names``."""
        ranges = self._merge([(s, t) for n, s, t in self.port_device_spans if n in names])
        return self._overlap(self.merged, ranges) / 1e9

    def busy_in_annotation(self, name: str) -> float:
        """Seconds of device operations inside the host's ranges of the
        benchmark's ``name`` spans (which synchronise the card at both ends)."""
        ranges = self._merge([(s, t) for n, s, t in self.annotations if n == name])
        return self._overlap(self.merged, ranges) / 1e9

    def _gaps(self):
        gaps, prev = [], self.t0
        for s, t in self.merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        return gaps

    def idle_under(self, names) -> float:
        """Seconds of device idle gaps whose midpoint lies in a host range of
        the port's spans named ``names``."""
        ranges = [(s, t) for n, s, t in self.port_spans if n in names]
        return sum(b - a for a, b in self._gaps()
                   if any(s <= (a + b) / 2 <= t for s, t in ranges)) / 1e9

    def idle_gaps(self, n: int = 10):
        """The idle time summed by the innermost span open at each gap's
        midpoint, the port's spans included."""
        inner = sorted(self.annotations + self.port_spans, key=lambda a: a[2] - a[1])
        by = {}
        for a, b in self._gaps():
            mid = (a + b) / 2
            label = next((nm for nm, s, t in inner if s <= mid <= t), "between units")
            by[label] = by.get(label, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class PortRun(harness.Run):
    """A run whose units the port's recorder follows (see the module)."""

    last = None
    recorder_on = True
    sync_debug = False

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.unit_counts = {}        # unit index -> the recorder's host counters at its end
        self.sync_warnings = {}      # unit index -> Counter of "file:line"
        self.snapshot = None
        PortRun.last = self

    @contextlib.contextmanager
    def span(self, name: str):
        if name != "unit":
            with super().span(name):
                yield
            return
        trace = _recorder()
        if self.unit_index == 0:
            if trace is not None:
                trace.reset()
                trace.enable(self.recorder_on)
            if self.sync_debug:
                import torch

                torch.cuda.set_sync_debug_mode("warn")
        with contextlib.ExitStack() as stack:
            if self.sync_debug:
                caught = stack.enter_context(warnings.catch_warnings(record=True))
                warnings.simplefilter("always")
            with super().span(name):
                yield
        if self.sync_debug:
            self.sync_warnings[self.unit_index] = collections.Counter(
                f"{Path(w.filename).name}:{w.lineno}" for w in caught
                if "synchroniz" in str(w.message))
        if trace is not None:
            self.unit_counts[self.unit_index] = trace.counts()

    def finish(self) -> None:
        """After the window: the recorder off and read once."""
        trace = _recorder()
        if self.sync_debug:
            import torch

            torch.cuda.set_sync_debug_mode("default")
        if trace is not None:
            trace.enable(False)
            self.snapshot = trace.snapshot()


def _unit_deltas(run: PortRun):
    """Each counted unit's host counters: ``(unit index, {name: count})``."""
    prev = {}
    out = []
    for i, u in enumerate(run.units):
        now = run.unit_counts.get(i)
        if now is None:
            continue
        if u.get("counted"):
            out.append((i, {k: v - prev.get(k, 0) for k, v in now.items()}))
        prev = now
    return out


def _mean(values):
    return statistics.fmean(values) if values else None


def readings(run: PortRun) -> dict:
    """The readings, each a number a counted scan unless its name says
    otherwise; a reading without data is left out.

    - ``cov_ms``, ``corr_ms``, ``solve_ms`` (device trace): device busy time
      inside the device-side ranges of ``gicp.covariances``,
      ``gicp.correspond`` and ``gicp.solve``, over the traced counted units;
      ``aligner_busy_ms`` the busy time inside the benchmark's ``aligner``
      spans, which the three should nearly fill.
    - ``iter_idle_ms`` (device trace): device idle time whose midpoint lies
      in a ``gicp.iteration`` span.
    - ``readback_wait_ms`` (port spans): host time inside ``sync.*`` spans,
      over all counted units.
    - ``readbacks`` (counters): ``sync.*`` counts a counted unit, and
      ``readbacks_by_site`` each site's.
    - ``probe_calls`` (counters): ``search.auto_cell_params`` calls a
      counted unit.
    - ``knn_slots`` (counters, Mslot): ``cell_list.knn.slots``; ``knn_cap``
      and ``corr_cap`` the caps that the slot counts imply per pair, rounded
      (``cell_list.rows`` over ``2 + iterations`` stands for the pair's
      capacity; source and target differ by a few hundred rows).
    - ``row_use`` (counters, share): ``cell_list.valid_rows`` over
      ``cell_list.rows`` over the window.
    - ``sync_warnings`` (``--sync-debug 1``): warnings a counted unit, and
      ``sync_warning_sites`` their sum by line over the counted units.
    """
    out = {}
    counted_idx = [i for i, u in enumerate(run.units) if u.get("counted")]
    deltas = _unit_deltas(run)
    if deltas:
        syncs = [sum(v for k, v in d.items() if k.startswith("sync.")) for _, d in deltas]
        out["readbacks"] = _mean(syncs)
        sites = collections.Counter()
        for _, d in deltas:
            sites.update({k: v for k, v in d.items() if k.startswith("sync.")})
        out["readbacks_by_site"] = {k: v / len(deltas) for k, v in sorted(sites.items())}
        out["probe_calls"] = _mean([d.get("search.probe_calls", 0) for _, d in deltas])
        knn = [d.get("cell_list.knn.slots", 0) for _, d in deltas]
        out["knn_slots"] = _mean(knn) / 1e6
        caps_k, caps_c = [], []
        for i, d in deltas:
            its = run.units[i].get("iterations")
            rows = d.get("cell_list.rows", 0)
            if its and rows:
                cap = rows / (2 + its)
                caps_k.append(d.get("cell_list.knn.slots", 0) / (2 * 27 * cap))
                caps_c.append(d.get("cell_list.nn1.slots", 0) / (8 * its * cap))
        if caps_k:
            out["knn_cap"] = sorted({round(c) for c in caps_k})
            out["corr_cap"] = sorted({round(c) for c in caps_c})
    snap = run.snapshot
    if snap is not None:
        c = snap["counters"]
        if c.get("cell_list.rows") and "cell_list.valid_rows" in c:
            out["row_use"] = c["cell_list.valid_rows"] / c["cell_list.rows"]
        ranges = [(run.units[i]["t0"], run.units[i]["t1"]) for i in counted_idx]
        wait = 0.0
        for name, _, t0, t1 in snap["spans"]:
            if name.startswith("sync.") and t1 is not None:
                mid = (t0 + t1) / 2e9
                if any(a <= mid <= b for a, b in ranges):
                    wait += (t1 - t0) / 1e9
        if snap["spans"] and counted_idx:
            out["readback_wait_ms"] = wait * 1e3 / len(counted_idx)
    tr = run.trace
    if isinstance(tr, PortTrace) and tr.port_device_spans:
        traced = int(run.traffic.get("trace_units", 8))
        n = sum(1 for u in run.units[:traced] if u.get("counted"))
        if n:
            for key, names in (("cov_ms", ["gicp.covariances"]),
                               ("corr_ms", ["gicp.correspond"]),
                               ("solve_ms", ["gicp.solve"])):
                out[key] = tr.busy_under(names) * 1e3 / n
            out["aligner_busy_ms"] = tr.busy_in_annotation("aligner") * 1e3 / n
            out["iter_idle_ms"] = tr.idle_under(["gicp.iteration"]) * 1e3 / n
    if run.sync_warnings:
        per = [sum(run.sync_warnings.get(i, {}).values()) for i in counted_idx]
        out["sync_warnings"] = _mean(per)
        sites = collections.Counter()
        for i in counted_idx:
            sites.update(run.sync_warnings.get(i, {}))
        out["sync_warning_sites"] = dict(sites.most_common())
    return out


def main(argv=None, device=None, overrides=None, root=None) -> int:
    """One run of run.py's ``main`` with :class:`PortRun` and
    :class:`PortTrace` in the harness's place; ``device``, ``overrides`` and
    ``root`` are run.py's (for the benchmark's own tests)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    ap.add_argument("--sync-debug", type=int, choices=(0, 1), default=0)
    args, rest = ap.parse_known_args(argv)
    PortRun.recorder_on = bool(args.recorder)
    PortRun.sync_debug = bool(args.sync_debug)
    saved = harness.Run, harness.Trace
    harness.Run, harness.Trace = PortRun, PortTrace
    try:
        rc = bench_run.main(rest, device=device, overrides=overrides, root=root)
    finally:
        harness.Run, harness.Trace = saved
    run = PortRun.last
    if rc != 0 or run is None:
        return rc
    run.finish()
    print(json.dumps({"port_readings": readings(run), "seed": run.seed,
                      "recorder": args.recorder, "trace": int(run.tracing)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
