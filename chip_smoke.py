#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pcl_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pcl_tpu_torch/csrc`` and then:

1. holds each kernel against its plain PyTorch version on the card, at
   ragged shapes, with masked targets, with no valid target, with exact ties
   and at the main path's shape (120k x 120k);
2. path A, the kernel path: point-to-point ICP with an infinite gate (the
   brute backend: one 120k x 120k 1-NN sweep per iteration) on a 120k-point
   pair moved by a known motion, then ``fitness_score``; checks the launch
   count, the recovered motion, and the same ICP with the plain 1-NN;
3. path B, the cell backend: ICP with a 1 m gate on a prebuilt dense grid
   (cap 8, 53^3 cells), 20 iterations with every epsilon 0.

The pair is uniform in a 100 m cube with 0.05 m Gaussian noise (seed 0),
the source moved by 0.25 deg about z and (0.10, -0.05, 0.08) m. Any failed
check raises, so the exit code is non-zero. It prints the card's name and
power limit, one JSON line describing every kernel, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it prints no result
and exits non-zero.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS = 120_000
NOISE = 0.05
MOTION_DEG = 0.25
MOTION_T = (0.10, -0.05, 0.08)
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def make_pair(n: int, seed: int = 0):
    """bench.py's pair: target uniform in [-50, 50]^3, source = target plus
    N(0, 0.05^2) noise; the source is then moved by the known motion M.
    Returns (moved source, target, M)."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-50, 50, size=(n, 3)).astype(np.float32)
    src = tgt + rng.normal(scale=NOISE, size=(n, 3)).astype(np.float32)
    a = math.radians(MOTION_DEG)
    M = np.eye(4)
    M[:3, :3] = [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]]
    M[:3, 3] = MOTION_T
    moved = (src @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    return moved, tgt, M


def residual_motion(T: torch.Tensor, M: np.ndarray):
    """Translation (m) and rotation (deg) left in T @ M; zero if ICP
    recovered the inverse of the motion exactly."""
    E = T.double().cpu().numpy() @ M
    R = E[:3, :3]
    # atan2 of the skew and symmetric parts stays accurate at tiny angles
    skew = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    ang = math.degrees(math.atan2(np.linalg.norm(skew), 0.5 * (np.trace(R) - 1)))
    return float(np.linalg.norm(E[:3, 3])), ang


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def nn1_bound_ms(nq: int, m: int):
    """Least time for one masked 3-D 1-NN sweep on this card. Operations:
    per (query, target) pair 3 FMAs, a compare and a select, 5 float32
    lane-instructions, at the float32 issue rate (peak FLOP/s / 2, an FMA
    counting 2). Bytes: queries and targets read once (12 B each, 1 B
    mask), index and distance written once. The larger bounds."""
    ops_s = 5.0 * nq * m / (PEAK_FP32_FLOPS / 2)
    bytes_s = (12.0 * nq + 13.0 * m + 8.0 * nq) / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def phase1_nn1(nn1_mod, moved, tgt):
    """Kernel against plain on the card; returns the kernel's record."""
    rng = np.random.default_rng(1)
    dev = "cuda"

    def case(name, t, m, q):
        t, m, q = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (t, m, q))
        ik, dk = nn1_mod.nn1(t, m, q)
        ip, dp = nn1_mod.nn1_plain(t, m, q)
        torch.cuda.synchronize()
        check(torch.equal(torch.isfinite(dk), torch.isfinite(dp)), f"{name}: +inf differs")
        fin = torch.isfinite(dk)
        err = float((dk[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0
        miss = ik != ip
        n_miss = int(miss.sum())
        # the plain version repeats the kernel's float32 arithmetic, so the
        # two agree bit for bit but for double-rounding in its float64
        # emulation of the FMA: a differing winner must be a near-tie
        if n_miss:
            qq, tk, tp = q[miss], t[ik[miss].long()], t[ip[miss].long()]
            scale = (qq * qq).sum(1) + (tk * tk).sum(1) + (tp * tp).sum(1)
            check(bool(((dk[miss] - dp[miss]).abs() <= 1e-6 * scale).all()),
                  f"{name}: kernel and plain disagree beyond a near-tie")
        check(n_miss <= 1e-5 * len(q), f"{name}: {n_miss} differing indices")
        # tolerance: 1e-6 of the squared distance scale (float32 rounding)
        check(err <= 1e-6 * max(1.0, float(dp[fin].abs().max()) if bool(fin.any()) else 1.0),
              f"{name}: d2 differs by {err}")
        print(f"phase 1: nn1 {name}: Q={len(q)} M={len(t)} differing indices {n_miss} "
              f"max |d2 kernel - plain| {err:.3e}", flush=True)
        return err, (t, m, q)

    def pts(n, lo=-5.0, hi=5.0):
        return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)

    errs = []
    errs.append(case("ragged+masked", pts(3001), rng.uniform(size=3001) > 0.1, pts(1000))[0])
    errs.append(case("no valid target", pts(500), np.zeros(500, bool), pts(77))[0])
    one = np.zeros(700, bool)
    one[513] = True
    errs.append(case("one valid target", pts(700), one, pts(300))[0])
    base = pts(2100)
    t_dup = np.concatenate([base, base[::-1], base])         # exact ties across tiles
    q_dup = np.concatenate([base[rng.integers(0, 2100, 400)], pts(113)])
    m_dup = np.ones(len(t_dup), bool)
    m_dup[:50] = False
    errs.append(case("duplicates (ties)", t_dup, m_dup, q_dup)[0])
    errs.append(case("empty target", np.zeros((0, 3), np.float32), np.zeros(0, bool), pts(5))[0])
    err, (t, m, q) = case("main path 120k x 120k", tgt, np.ones(len(tgt), bool), moved)
    errs.append(err)

    for bad, why in ((lambda: nn1_mod.nn1(t[:, :2].contiguous(), m, q[:, :2].contiguous()), "D != 3"),
                     (lambda: nn1_mod.nn1(t.double(), m, q.double()), "float64"),
                     (lambda: nn1_mod.nn1(t.t().contiguous().t(), m, q), "non-contiguous")):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"nn1 wrapper accepted {why}")

    ms = cuda_ms(lambda: nn1_mod.nn1(t, m, q), reps=20)
    plain_ms = cuda_ms(lambda: nn1_mod.nn1_plain(t, m, q), reps=2)
    bound_s, bound_by = nn1_bound_ms(len(q), len(t))
    print(f"phase 1: nn1 kernel {ms:.3f} ms per 120k x 120k sweep, plain {plain_ms:.1f} ms, "
          f"bound {bound_s * 1e3:.3f} ms ({bound_by}) [{card_line()}]", flush=True)
    return {"name": "nn1", "route": "cuda", "source": "pcl_tpu_torch/csrc/nn1.cu",
            "replaces": "pcl_tpu/ops/pallas_nn.py:32", "launches": None,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "library_ms": None}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_breakdown(tag: str, fn) -> None:
    """One run of ``fn`` under torch.profiler: device time against the host
    clock (the idle share) and the operators that take the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs = timed(fn)
    # device-side events only (kernels, copies): an operator's own row
    # repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        print(f"{tag}: profile: device time not measured", flush=True)
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    names = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top)
    print(f"{tag}: profile: {sum(e.count for e in events)} device events, busy "
          f"{busy_us / 1e3:.3f} ms of {secs * 1e3:.3f} ms host (idle share "
          f"{1 - busy_us / 1e6 / secs:.3f}); top: {names}", flush=True)


def phase2_path_a(nn1_mod, src, tgt, M, record):
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.registration import icp as icp_mod
    from pcl_tpu_torch.search import bruteforce

    source, target = make_cloud(src), make_cloud(tgt)
    kw = dict(max_corr_dist=math.inf, max_iterations=30)
    icp_mod.icp(source, target, max_iterations=2)          # warm-up (libraries)

    nn1_mod.nn1.launches = 0
    res, secs = timed(lambda: icp_mod.icp(source, target, **kw))
    fit = icp_mod.fitness_score(source, target, res.transform)
    torch.cuda.synchronize()
    launches = nn1_mod.nn1.launches
    record["launches"] = launches

    it = int(res.iterations)
    code = int(res.convergence_state)
    dt, dang = residual_motion(res.transform, M)
    ms_iter = secs * 1e3 / it
    print(f"phase 2: path A (brute, kernel) {it} iterations, code {code}, fitness "
          f"{float(res.fitness):.6f}, fitness_score {float(fit):.6f}, nn1 launches "
          f"{launches}; residual motion {dt:.2e} m {dang:.2e} deg; "
          f"{ms_iter:.3f} ms per ICP iteration [{card_line()}]", flush=True)
    device_breakdown("phase 2", lambda: icp_mod.icp(source, target, **kw))
    check(launches >= it + 1, f"nn1 kernel launched {launches} times for {it} iterations")
    check(bool(res.converged), f"path A did not converge (code {code})")
    check(dt <= 1e-3 and dang <= 0.01, f"path A missed the motion: {dt} m, {dang} deg")
    check(bool(torch.isfinite(res.transform).all()), "path A transform not finite")
    check(0.8 * 3 * NOISE ** 2 < float(fit) < 1.2 * 3 * NOISE ** 2,
          f"path A fitness {float(fit)} far from 3 sigma^2")

    # the same ICP with the plain 1-NN on the card
    kernel_nn1 = bruteforce.nn1
    bruteforce.nn1 = nn1_mod.nn1_plain
    try:
        plain, psecs = timed(lambda: icp_mod.icp(source, target, **kw))
    finally:
        bruteforce.nn1 = kernel_nn1
    pit = int(plain.iterations)
    tdiff = float((plain.transform - res.transform).abs().max())
    print(f"phase 2: path A with plain nn1: {pit} iterations, code "
          f"{int(plain.convergence_state)}, max |T - T_kernel| {tdiff:.2e}, "
          f"{psecs * 1e3 / pit:.1f} ms per ICP iteration", flush=True)
    check(int(plain.convergence_state) == code, "plain-nn1 ICP ended with another code")
    check(abs(pit - it) <= 1, f"plain-nn1 ICP took {pit} iterations against {it}")
    check(tdiff <= 1e-5, f"plain-nn1 ICP transform differs by {tdiff}")

    # a small noise-free pair against the port's own CPU run (with noise the
    # absolute-MSE test waits for a fixed point that rounding decides)
    small_tgt = tgt[:2048]
    small_src = (small_tgt @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    on_gpu = icp_mod.icp(make_cloud(small_src), make_cloud(small_tgt), **kw)
    on_cpu = icp_mod.icp(make_cloud(small_src, device="cpu"),
                         make_cloud(small_tgt, device="cpu"), **kw)
    sdiff = float((on_gpu.transform.cpu() - on_cpu.transform).abs().max())
    print(f"phase 2: 2048-point ICP, card {int(on_gpu.iterations)} iterations code "
          f"{int(on_gpu.convergence_state)}, CPU {int(on_cpu.iterations)} code "
          f"{int(on_cpu.convergence_state)}, max |T_card - T_cpu| {sdiff:.2e}", flush=True)
    check(int(on_gpu.convergence_state) == int(on_cpu.convergence_state)
          and abs(int(on_gpu.iterations) - int(on_cpu.iterations)) <= 1
          and sdiff <= 1e-5, "ICP on the card disagrees with the CPU run")
    return ms_iter


def phase3_path_b(src, tgt, M):
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.registration import icp as icp_mod

    source, target = make_cloud(src), make_cloud(tgt)
    grid = (53, 53, 53)
    table, bsecs = timed(lambda: icp_mod.build_index(target, 1.0, cell_cap=8, grid_dims=grid))
    kw = dict(max_corr_dist=1.0, max_iterations=20, transformation_eps=0.0,
              abs_mse_eps=0.0, rel_mse_eps=0.0, cell_cap=8, grid_dims=grid, index=table)
    icp_mod.icp(source, target, **dict(kw, max_iterations=2))     # warm-up
    res, secs = timed(lambda: icp_mod.icp(source, target, **kw))
    it = int(res.iterations)
    dt, dang = residual_motion(res.transform, M)
    ms_iter = secs * 1e3 / it
    print(f"phase 3: path B (dense cell grid 53^3, cap 8) index build {bsecs * 1e3:.1f} ms; "
          f"{it} iterations, truncated {bool(res.truncated)}, fitness {float(res.fitness):.6f}, "
          f"correspondences {int(res.num_correspondences)}; residual motion {dt:.2e} m "
          f"{dang:.2e} deg; {ms_iter:.3f} ms per ICP iteration [{card_line()}]", flush=True)
    device_breakdown("phase 3", lambda: icp_mod.icp(source, target, **kw))
    check(not bool(res.truncated), "path B truncated: raise cell_cap")
    check(it == 20, f"path B ran {it} iterations")
    check(0.8 * 3 * NOISE ** 2 < float(res.fitness) < 1.2 * 3 * NOISE ** 2,
          f"path B fitness {float(res.fitness)} far from 3 sigma^2")
    check(dt <= 1e-3 and dang <= 0.01, f"path B missed the motion: {dt} m, {dang} deg")
    return ms_iter


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import pcl_tpu_torch  # noqa: F401  (sets full-float32 matmuls)
    from pcl_tpu_torch.ops import _build
    from pcl_tpu_torch.ops import nn1 as nn1_mod

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"set-up: built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        for line in _build.build_log(lib.name.split("-")[0]).splitlines():
            if "registers" in line or "spill" in line:
                print(f"set-up: {lib.name}: {line.strip()}", flush=True)

    src, tgt, M = make_pair(N_POINTS)
    record = phase1_nn1(nn1_mod, src, tgt)
    ms_a = phase2_path_a(nn1_mod, src, tgt, M, record)
    ms_b = phase3_path_b(src, tgt, M)
    print(f"summary: path A {ms_a:.3f} ms/iteration, path B {ms_b:.3f} ms/iteration, "
          f"nn1 {record['ms']:.3f} ms/sweep (bound {record['bound_ms']:.3f} ms, "
          f"plain {record['plain_ms']:.1f} ms) [{card}]", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
