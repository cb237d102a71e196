#!/usr/bin/env python3
"""Run one cell of the benchmark of pcl_tpu_torch once, on the GPU it is started on.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its files are
found by name (see ``benchmark/harness.py``). Set-up (counted from the start
of the process: imports, the kernels' build or load, the data made on the card
from ``--seed``, a warm-up of the cell's own flow) comes first; then units of
the cell's flow run back to back, each started when the last one's pose has
been read back, for ``--seconds``. With ``--trace 0`` the last line of
standard output is the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from the benchmark's spans and from ``torch.profiler``
over the window's first units. After the window, the check holds a sample of
what the window produced against the plain reference under
``benchmark/reference`` and prints each number compared beside its limit, as
the last lines of standard error and under ``checks``, the result's last key.

``--control`` (not used by a measured run) puts the reference computed in
bfloat16 in the port's place for the check: it has to come out not correct.
``--check-pairs`` checks more pairs than the cell's file says (for reading
the numbers that limits are set from).

Exits with 2, and prints no result, where there is no GPU or fewer than the
cell asks for, and with 3 where ``jax``, ``jaxlib``, ``flax`` or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every cache at a fixed place inside the checkout; a library that would load
# JAX by itself is told not to
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
# load from one process with one host thread: the host's share of each unit
# (the density probes, numpy) runs on one core, whatever the environment says
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "pcl_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``pcl_tpu_torch`` is not ``pcl_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--check-pairs", type=int, default=None,
                    help="check this many units instead of the cell's count (for setting limits)")
    return ap.parse_args(argv)


def main(argv=None, device=None, overrides=None, root=None) -> int:
    """One run. ``device``, ``overrides`` and ``root`` are for the
    benchmark's own tests: a CPU rehearsal at a small size
    (``{"config": {...}, ...}`` updates the cell's files as loaded), from a
    copy of the benchmark at ``root``."""
    args = parse(argv)
    import torch

    from benchmark import harness

    if device is None:
        wl = [w for w in harness.spec_of()["workloads"] if w["name"] == args.workload]
        chips = wl[0]["chips"] if wl else 1
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: a CUDA GPU is needed ({chips} asked for, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found)",
                  file=sys.stderr)
            return 2
        device = "cuda"
    cuda = device == "cuda"
    if cuda:
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace), device,
                      root=root or harness.ROOT, overrides=overrides)
    if args.check_pairs is not None:
        run.cell["check"]["pairs"] = args.check_pairs
    driver = harness.load_module(run.bench / "drivers" / f"{run.traffic['driver']}.py",
                                 run.traffic["driver"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - T_START

    trace_units = int(run.traffic.get("trace_units", 8))
    prof = None
    if run.tracing:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.start()
    t_w0 = time.perf_counter()
    deadline = t_w0 + run.seconds
    while True:
        run.unit_index += 1
        t0 = time.perf_counter()
        with run.span("unit"):
            rec = driver.unit(state, run)
        rec["t0"], rec["t1"] = t0, time.perf_counter()
        run.units.append(rec)
        if prof is not None and len(run.units) >= trace_units:
            run.sync()
            prof.stop()
            run.trace = harness.Trace(prof)
            prof = None
        if time.perf_counter() >= deadline:
            break
    run.window_s = run.units[-1]["t1"] - t_w0
    if prof is not None:
        prof.stop()
        run.trace = harness.Trace(prof)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3

    # the metrics of this cell
    spec, name = run.spec, run.name
    e2e = [m for m in spec["end_to_end"] if harness.applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if harness.applies(m, name, reported)]
    metrics = {}
    for m in (layer if run.tracing else e2e):
        reader = harness.load_module(run.bench / "metrics" / f"{m['name']}.py", m["name"])
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    counted = [u for u in run.units if u.get("counted")]
    its = [u["iterations"] for u in counted if "iterations" in u]
    print(f"benchmark: {run.name} seed {run.seed}: setup {run.setup_s:.3f} s, window "
          f"{run.window_s:.3f} s, {len(counted)} units counted, iterations {its}, ms "
          f"{[round((u['t1'] - u['t0']) * 1e3) for u in run.units]}, "
          f"peak {peak} bytes; "
          f"{json.dumps(metrics)}", file=sys.stderr, flush=True)

    # the check, once the port's state is freed
    driver.release(state)
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    with torch.no_grad():
        checks = driver.verify(state, run, control=args.control)
    check_s = time.perf_counter() - t_check
    correct = all(harness.finite(v) <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    if cuda:
        device_info["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": len(counted),
              "failed": sum(1 for u in counted if u.get("failed")),
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": harness.finite(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(f"benchmark: check {check_s:.3f} s", file=sys.stderr)
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


if __name__ == "__main__":
    sys.exit(main())
