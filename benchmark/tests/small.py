"""A run of a cell on the CPU at a size a test can hold: the sensor's rings
and azimuths thinned, the drive cut short, the check's sample kept within the
units a short window reaches. The port runs its plain versions of the
kernels there."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the CPU runs of the tests take more host threads than a measured run
os.environ.setdefault("OMP_NUM_THREADS", "4")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SENSOR = {"rings": [[8, 2.0, -8.33], [8, -8.83, -24.33]], "azimuth_steps": 750}
DRIVE = {"scans": 8}
CHECK = {"pairs": 1, "within": 2, "knn_cell": 0.8}
TRACE_UNITS = 3


def run_small(workload: str, seed: int = 2147483999, seconds: float = 6.0, trace: int = 0,
              control: bool = False, limits: dict = None, root: Path = ROOT):
    """One run on the CPU; returns ``(exit code, result line as a dict or
    None, standard error)``. ``limits`` updates the cell's limits; ``root``
    is a copy of the benchmark to run from."""
    from benchmark import harness
    from benchmark import run as bench_run

    wl = next(w for w in harness.spec_of(root)["workloads"] if w["name"] == workload)
    bench = root / "benchmark"
    cfg = harness.load_json(bench / "configs" / f"{wl['config']}.json")
    tr = harness.load_json(bench / "traffic" / f"{wl['traffic']}.json")
    over = {"config": {"sensor": dict(cfg["sensor"], **SENSOR)},
            "traffic": {"drive": dict(tr["drive"], **DRIVE), "trace_units": TRACE_UNITS},
            "cell": {"check": dict(CHECK)}}
    if limits:
        over["cell"]["limits"] = limits
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)] + (["--control"] if control else [])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(argv, device="cpu", overrides=over, root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
