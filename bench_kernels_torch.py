#!/usr/bin/env python3
"""Time the CUDA kernels of pcl_tpu_torch through their wrappers, on one GPU.

    python3 bench_kernels_torch.py [--tree DIR] [--define NAME=VALUE ...]
                                   [--slices S ...] [--check] [--only nn1|segsum]
                                   [--tag TEXT]

``--tree DIR`` imports ``pcl_tpu_torch`` from another checkout (an older
commit unpacked with ``git archive``, say), so that two versions of a kernel
can be timed in turns on one card: the script only calls the wrappers
``ops.nn1.nn1(target, mask, queries)`` and
``ops.segsum.segment_sum_sorted(vals, seg)``, which every version has.
``--define`` adds ``-DNAME=VALUE`` to nvcc's flags (``csrc/nn1.cu`` reads
``NN1_R``, ``NN1_SUB`` and ``NN1_UNROLL``). ``--slices`` times the 120k x 120k
sweep with the targets cut into the given numbers of slices beside the
wrapper's own choice. ``--check`` holds each kernel against its plain version
at the timed shapes first. The SM clock and the power draw are read with
nvidia-smi while 100 sweeps of 120k x 120k are queued.

Inputs come from seed 0: the 1-NN pair is uniform in a 100 m cube with 0.05 m
noise; the segment sums take 120,000 x 4 rows with a new segment at 60% of
the rows (about 72,000 segments, the voxel grid's shape at a 0.2 m leaf), one
segment of all rows, and runs of about 500 rows. Times are CUDA-event means
per call; ``host_us`` is the host clock per call of a loop that never waits
for the device. Prints one JSON object per line, the card's name and power
limit in each. Exits non-zero without a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def load_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_us(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / reps


def segments(rng, n, w, p_new):
    steps = (rng.random(n) < p_new).astype(np.int32)
    steps[:1] = 0
    seg = np.cumsum(steps).astype(np.int32)
    vals = rng.normal(size=(n, w)).astype(np.float32)
    return torch.from_numpy(vals).cuda(), torch.from_numpy(seg).cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None)
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--slices", type=int, action="append", default=[])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--only", choices=["nn1", "segsum"], default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels_torch: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        sys.path.insert(0, args.tree)
    import pcl_tpu_torch  # noqa: F401
    from pcl_tpu_torch.ops import _build
    from pcl_tpu_torch.ops import nn1 as nn1_mod
    from pcl_tpu_torch.ops import segsum

    defines = dict(d.split("=", 1) for d in args.define)
    _build.NVCC_FLAGS.extend(f"-D{k}={v}" for k, v in defines.items())
    if "NN1_R" in defines:
        nn1_mod.QUERY_BLOCK = 128 * int(defines["NN1_R"])
    if "NN1_SUB" in defines:
        nn1_mod.SUB_TILE = int(defines["NN1_SUB"])
    card = card_line()
    base = {"tag": args.tag, "tree": args.tree or ".", "defines": defines, "card": card}

    def emit(**kw):
        print(json.dumps({**base, **kw}), flush=True)

    _build.build_all()
    for name in ("nn1", "segsum"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}", flush=True)

    rng = np.random.default_rng(0)
    n = 120_000
    if args.only != "segsum":
        tgt = rng.uniform(-50, 50, size=(n, 3)).astype(np.float32)
        src = tgt + rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
        t, q = torch.from_numpy(tgt).cuda(), torch.from_numpy(src).cuda()
        m = torch.ones(n, dtype=torch.bool, device="cuda")
        for nq, reps in ((n, 20), (2048, 50), (1, 50)):
            qq = q[:nq].contiguous()
            if args.check:
                ik, dk = nn1_mod.nn1(t, m, qq)
                ip, dp = nn1_mod.nn1_plain(t, m, qq)
                emit(kernel="nn1", nq=nq, m=n, differing_indices=int((ik != ip).sum()),
                     max_abs_d2_diff=float((dk - dp).abs().max()))
            emit(kernel="nn1", nq=nq, m=n, ms=cuda_ms(lambda: nn1_mod.nn1(t, m, qq), reps),
                 host_us=host_us(lambda: nn1_mod.nn1(t, m, qq), reps))
        t2k = t[:2048].contiguous()
        emit(kernel="nn1", nq=2048, m=2048,
             ms=cuda_ms(lambda: nn1_mod.nn1(t2k, m[:2048], q[:2048]), 50))
        for s in args.slices:
            emit(kernel="nn1", nq=n, m=n, slices=s,
                 ms=cuda_ms(lambda: nn1_mod.nn1(t, m, q, slices=s), 20))
        if hasattr(nn1_mod, "nn1_plan"):
            emit(kernel="nn1", slots=nn1_mod.device_slots(torch.cuda.current_device()),
                 plan_120k=nn1_mod.nn1_plan(n, n, nn1_mod.device_slots(0)),
                 plan_2048=nn1_mod.nn1_plan(2048, n, nn1_mod.device_slots(0)))
        for _ in range(100):
            nn1_mod.nn1(t, m, q)
        emit(kernel="nn1", under_load=load_line())
        torch.cuda.synchronize()
    if args.only == "nn1":
        return 0

    for name, p_new, reps in (("voxel-like", 0.6, 200), ("one segment", 0.0, 5),
                              ("runs of ~500", 0.002, 50)):
        vals, seg = segments(rng, n, 4, p_new)
        if args.check:
            k1 = segsum.segment_sum_sorted(vals, seg)
            plain = segsum.segment_sum_sorted_plain(vals, seg)
            mag = segsum.segment_sum_sorted_plain(vals.abs(), seg).sum(1, keepdim=True)
            emit(kernel="segsum", case=name, max_abs_diff=float((k1 - plain).abs().max()),
                 within=bool(((k1 - plain).abs() <= 1e-6 * mag).all()),
                 bitwise_twice=bool(torch.equal(k1, segsum.segment_sum_sorted(vals, seg))))
        emit(kernel="segsum", case=name, n=n, w=4, segments=int(seg[-1]) + 1,
             ms=cuda_ms(lambda: segsum.segment_sum_sorted(vals, seg), reps),
             host_us=host_us(lambda: segsum.segment_sum_sorted(vals, seg), reps))
    if hasattr(segsum, "launch_floor"):
        noop = segsum.launch_floor()
        emit(kernel="empty launch", ms=cuda_ms(noop, 500), host_us=host_us(noop, 500))
        # the host side of a call, piece by piece
        dev = vals.device
        emit(kernel="segsum wrapper parts", host_us={
            "current_stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream, 500),
            "torch.empty": host_us(lambda: torch.empty((n, 4), device=dev), 500),
            "_check": host_us(lambda: segsum._check(vals, seg), 500),
            "data_ptr x3": host_us(lambda: (vals.data_ptr(), seg.data_ptr(), vals.data_ptr()),
                                   500)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
