#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pcl_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pcl_tpu_torch/csrc`` and then:

1. holds each kernel against its plain PyTorch version on the card, at
   ragged shapes, with masked targets, with no valid target, with exact ties
   (also across sub-tiles, tiles and target slices, and at the origin) and at
   the main path's shape (120k x 120k); 2048 x 120k, the shape of a
   downsampled source against a dense map, is checked and timed as well;
2. path A, the kernel path: point-to-point ICP with an infinite gate (the
   brute backend: one 120k x 120k 1-NN sweep per iteration) on a 120k-point
   pair moved by a known motion, then ``fitness_score``; checks the launch
   count, the recovered motion, and the same ICP with the plain 1-NN;
3. path B, the cell backend: ICP with a 1 m gate on a prebuilt dense grid
   (cap 8, 53^3 cells), 20 iterations with every epsilon 0;
4. kernel B2 (segmented sums) against its plain version: ragged N, one
   segment of all rows, every row its own segment, no valid row, N = 0,
   W = 1, 7 and 131, tails of N and 2^28, runs of ~500 rows, runs of one
   row less, as many and one more than a thread adds alone, gaps between the
   ids, the voxel grid's own input from
   scan 0, and from a cloud whose bounding box holds more than 2^30 cells
   (the three-key sort), whose voxel_downsample on the card must launch the
   kernel once and match the CPU run; two launches must be bitwise equal;
   kernel, plain and torch.segment_reduce times beside the bound and beside
   an empty kernel launched the same way;
5. path C, the odometry front end at KITTI scan size: six 120k-point scans
   of a synthetic street, each through voxel_downsample (B2), estimate_normals
   (k = 16, host probe, cell list) and point-to-plane odometry_sequence;
   checks B2's launch count, convergence, truncation, the trajectory error,
   scan 0 against the port's CPU run, and the same chain with the plain
   segment sum.

The pair of paths A and B is uniform in a 100 m cube with 0.05 m Gaussian
noise (seed 0), the source moved by 0.25 deg about z and (0.10, -0.05,
0.08) m; path C's street and scans come from seed 0. Any failed check
raises, so the exit code is non-zero. It prints the card's name and power
limit, one JSON line describing every kernel, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it prints no result
and exits non-zero.
"""

import json
import math
import re
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
# path C: the odometry front end on a synthetic KITTI-scale street
SCENE_POINTS = 2_400_000
N_SCANS = 6
SCAN_CAPACITY = 120_000
LEAF = 0.2
NORMAL_K = 16
SEQUENCE_KW = dict(fov_tan=1.2, z_range=(1.0, 60.0), max_points=SCAN_CAPACITY,
                   step_translation=0.5, step_rotation=0.02, noise=0.02)
# cell_cap 256, not 128: a 2 m cell at a facade-ground corner or a car holds
# up to ~250 of the 0.2 m voxels (CPU rehearsal of these six scans)
ICP_KW = dict(variant="point_to_plane", max_corr_dist=1.0, max_iterations=40,
              cell_cap=256)
# phase 4's cloud past 2^30 bounding-box cells: 4000 clusters of 8 points
FAR_LEAF = 0.1
FAR_CAPACITY = 40_000


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
    per (query, target) pair 3 FMAs and one minimum, 4 float32
    lane-instructions (the index of the minimum need not be tracked per
    pair), at the float32 instruction rate (peak FLOP/s / 2, an FMA counting 2).
    Bytes: queries and targets read once (12 B each, 1 B mask), index and
    distance written once. The larger bounds."""
    ops_s = 4.0 * nq * m / (PEAK_FP32_FLOPS / 2)
    bytes_s = (12.0 * nq + 13.0 * m + 8.0 * nq) / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def phase1_nn1(nn1_mod, moved, tgt):
    """Kernel against plain on the card; returns the kernel's record."""
    rng = np.random.default_rng(1)
    dev = "cuda"

    def case(name, t, m, q, slices=None):
        t, m, q = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (t, m, q))
        ik, dk = nn1_mod.nn1(t, m, q, slices=slices)
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
    # exact ties whose two copies sit either side of a sub-tile (32, 64, 128
    # targets), a 2048-target tile and a slice boundary (3 slices of 2048, 7
    # of 896), and far apart; the queries sit on the tied points
    t_tie = pts(6000)
    edges = [32, 64, 128, 896, 1792, 2048, 2688, 4096, 5376]
    for b in edges:
        t_tie[b] = t_tie[b - 1]
    t_tie[5000] = t_tie[5]
    q_tie = np.concatenate([t_tie[edges], t_tie[[5]], pts(90)])
    for slices in (None, 1, 3, 7):
        errs.append(case(f"ties across sub-tiles, tiles and slices (slices={slices})",
                         t_tie, np.ones(6000, bool), q_tie, slices=slices)[0])
    # fewer targets than one sub-tile; Q and M multiples of nothing, the
    # winner the last target of a ragged sub-tile
    errs.append(case("M = 17", pts(17), np.ones(17, bool), pts(3))[0])
    t_rag, q_rag = pts(2082), pts(1025)
    q_rag[:200] = t_rag[-1] + np.float32(1e-3)
    for slices in (None, 1, 5):
        errs.append(case(f"ragged Q = 1025, M = 2082, winner last (slices={slices})",
                         t_rag, np.ones(2082, bool), q_rag, slices=slices)[0])
    # a query on a target at the origin, twice in the target: scores +0.0
    # and -0.0 tie, and the lowest index wins
    t_zero = pts(300)
    t_zero[[3, 70, 257]] = 0.0
    t_zero[70] = -0.0
    q_zero = np.concatenate([np.zeros((2, 3), np.float32), pts(30)])
    q_zero[1] = -0.0
    errs.append(case("query and targets at the origin", t_zero, np.ones(300, bool), q_zero)[0])
    err, (t, m, q) = case("main path 120k x 120k", tgt, np.ones(len(tgt), bool), moved)
    errs.append(err)
    q2k = q[:2048].contiguous()
    errs.append(case("2048 x 120k", tgt, np.ones(len(tgt), bool), moved[:2048])[0])

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
    slots = nn1_mod.device_slots(torch.cuda.current_device())
    print(f"phase 1: nn1 kernel {ms:.3f} ms per 120k x 120k sweep, plain {plain_ms:.1f} ms, "
          f"bound {bound_s * 1e3:.3f} ms ({bound_by}); the card holds {slots} blocks, "
          f"(slices, slice length) {nn1_mod.nn1_plan(len(q), len(t), slots)} "
          f"[{card_line()}]", flush=True)
    ms2k = cuda_ms(lambda: nn1_mod.nn1(t, m, q2k), reps=50)
    bound2k, by2k = nn1_bound_ms(len(q2k), len(t))
    print(f"phase 1: nn1 kernel {ms2k * 1e3:.1f} us per 2048 x 120k sweep, bound "
          f"{bound2k * 1e6:.1f} us ({by2k}), (slices, slice length) "
          f"{nn1_mod.nn1_plan(len(q2k), len(t), slots)} [{card_line()}]", flush=True)
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


def make_street(seed: int = 0, n: int = SCENE_POINTS) -> np.ndarray:
    """A KITTI-like street in the scanner's frame (z forward, y up, the
    sensor at the origin), points spread uniformly by area: a ground plane
    1.7 m below the sensor (40 m wide, z 0..200 m), two building facades
    10 m either side (12 m tall), 40 poles (r 0.15 m, 5 m tall) every 10 m
    along both kerbs, and 10 car-sized boxes (4.5 x 1.8 x 1.5 m)."""
    rng = np.random.default_rng(seed)
    g = -1.7
    # planar patches: (origin, edge u, edge v)
    quads = [((-20, g, 0), (40, 0, 0), (0, 0, 200))]
    quads += [((s * 10, g, 0), (0, 12, 0), (0, 0, 200)) for s in (-1, 1)]
    for i in range(10):
        x0, z0 = (-4.9 if i % 2 else 3.1), 8.0 + 19.0 * i
        lo, (dx, dy, dz) = np.array([x0, g, z0]), (1.8, 1.5, 4.5)
        quads += [(lo + (0, dy, 0), (dx, 0, 0), (0, 0, dz)),          # roof
                  (lo, (dx, 0, 0), (0, dy, 0)), (lo + (0, 0, dz), (dx, 0, 0), (0, dy, 0)),
                  (lo, (0, dy, 0), (0, 0, dz)), (lo + (dx, 0, 0), (0, dy, 0), (0, 0, dz))]
    poles = [(s * 7.0, 5.0 + 10.0 * j) for s in (-1, 1) for j in range(20)]
    r_pole, h_pole = 0.15, 5.0
    quad_area = [np.linalg.norm(np.cross(u, v)) for _, u, v in quads]
    area = np.array(quad_area + [2 * np.pi * r_pole * h_pole] * len(poles))
    which = rng.choice(len(area), size=n, p=area / area.sum())
    a, b = rng.random(n), rng.random(n)
    out = np.empty((n, 3))
    nq = len(quads)
    o = np.array([q[0] for q in quads], float)
    u = np.array([q[1] for q in quads], float)
    v = np.array([q[2] for q in quads], float)
    isq = which < nq
    k = which[isq]
    out[isq] = o[k] + a[isq, None] * u[k] + b[isq, None] * v[k]
    k = which[~isq] - nq
    centre = np.array(poles)[k]
    th = 2 * np.pi * a[~isq]
    out[~isq] = np.stack([centre[:, 0] + r_pole * np.cos(th), g + h_pole * b[~isq],
                          centre[:, 1] + r_pole * np.sin(th)], 1)
    return out


def segsum_bound_ms(n: int, w: int, n_seg: int):
    """Least time for one segment sum of ``vals [n, w]`` on this card: the
    values and the ids read once (4 B each), the ``n_seg`` live output rows
    written once, against the n*w float32 additions at the float32 rate.
    The larger bounds (bytes, by far)."""
    bytes_s = (4.0 * n * w + 4.0 * n + 4.0 * n_seg * w) / PEAK_BYTES
    ops_s = float(n) * w / PEAK_FP32_FLOPS
    return (ops_s, "operations") if ops_s > bytes_s else (bytes_s, "bytes")


def far_clusters(seed: int = 3, n_clusters: int = 4000, per: int = 8) -> np.ndarray:
    """Clusters of ``per`` points in 0.15 m boxes scattered over a 4 km cube:
    at ``FAR_LEAF`` the bounding box holds ~6e13 cells, past the dense id's
    2^30, so voxel_downsample sorts the three cell keys; a cluster fills one
    to eight voxels."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-2000.0, 2000.0, size=(n_clusters, 1, 3))
    pts = centres + rng.uniform(0.0, 0.15, size=(n_clusters, per, 3))
    return pts.reshape(-1, 3).astype(np.float32)


def main_path_segments(segsum, cloud, leaf):
    """Kernel B2's inputs as ``voxel_downsample`` gives them for a cloud
    without attributes: the xyz columns and the weight column, cell-sorted
    (N x 4), their segment ids, and the number of voxels."""
    from pcl_tpu_torch.filters import voxel_grid

    order, seg_id, first = voxel_grid._sorted_cell_segments(cloud.xyz, cloud.mask, leaf)
    vals, seg = segsum.sorted_inputs(cloud.xyz, cloud.mask, order, seg_id)
    return vals, seg, int(first.sum())


def far_voxels_on_card(segsum):
    """voxel_downsample past 2^30 bounding-box cells on the card: one B2
    launch, and the same voxels as the CPU run (both add each voxel's points
    in the same order, so they should agree exactly; the tolerance, 1e-6 of
    the coordinate scale, would only absorb another float32 addition
    order). Returns the cloud on the card."""
    from pcl_tpu_torch import filters
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.filters import voxel_grid

    far = far_clusters()
    attrs = {"intensity": np.random.default_rng(4).random(len(far)).astype(np.float32)}
    cloud = from_numpy(far, attrs=attrs, capacity=FAR_CAPACITY)
    _, _, span = segsum.cell_grid(cloud.xyz, cloud.mask, FAR_LEAF)
    n_cells = float(voxel_grid._n_cells(span))
    check(n_cells >= 2 ** 30, f"far clusters span only {n_cells} cells")
    before = segsum.segment_sum_sorted.launches
    on_card = filters.voxel_downsample(cloud, FAR_LEAF)
    torch.cuda.synchronize()
    launches = segsum.segment_sum_sorted.launches - before
    on_cpu = filters.voxel_downsample(
        from_numpy(far, attrs=attrs, capacity=FAR_CAPACITY, device="cpu"), FAR_LEAF)
    check(launches == 1, f"voxel_downsample past 2^30 cells launched B2 {launches} times")
    check(torch.equal(on_card.mask.cpu(), on_cpu.mask),
          "past 2^30 cells: live voxels differ from the CPU run")
    xerr = float((on_card.xyz.cpu() - on_cpu.xyz).abs().max())
    ierr = float((on_card.attrs["intensity"].cpu() - on_cpu.attrs["intensity"]).abs().max())
    check(xerr <= 1e-6 * 2000.0 and ierr <= 1e-6,
          f"past 2^30 cells: card and CPU differ by {xerr} m, intensity {ierr}")
    print(f"phase 4: voxel_downsample past 2^30 cells ({n_cells:.3e} cells, "
          f"{len(far)} points): {int(on_card.mask.sum())} voxels, B2 launches {launches}, "
          f"card vs CPU max |centroid diff| {xerr:.3e} m, |intensity diff| {ierr:.3e}",
          flush=True)
    return cloud


def phase4_segsum(segsum, scan0: np.ndarray):
    """Kernel B2 against its plain version on the card; returns its record."""
    from pcl_tpu_torch.core.cloud import from_numpy

    rng = np.random.default_rng(2)
    dev = "cuda"

    def segments(n, w, p_new, valid_frac, tail):
        steps = (rng.random(n) < p_new).astype(np.int32)
        steps[:1] = 0
        seg = np.cumsum(steps).astype(np.int32)
        nvalid = int(n * valid_frac)
        seg[nvalid:] = tail
        vals = rng.normal(size=(n, w)).astype(np.float32)
        vals[nvalid:] = 0.0
        return torch.from_numpy(vals).to(dev), torch.from_numpy(seg).to(dev)

    def case(name, vals, seg):
        k1 = segsum.segment_sum_sorted(vals, seg)
        k2 = segsum.segment_sum_sorted(vals, seg)
        plain = segsum.segment_sum_sorted_plain(vals, seg)
        members = segsum.segment_sum_sorted_plain(torch.ones_like(vals[:, :1]), seg)[:, 0]
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), f"B2 {name}: two launches differ")
        # both add a segment's rows in ascending order from 0; 1e-6 sum|v|
        # would absorb another rounding order
        mag = segsum.segment_sum_sorted_plain(vals.abs(), seg).sum(1, keepdim=True)
        check(bool(((k1 - plain).abs() <= 1e-6 * mag).all()), f"B2 {name}: kernel != plain")
        live = members > 0
        check(bool((k1[~live] == 0).all()), f"B2 {name}: a row without members is not 0")
        # a run that one thread adds alone is added in the plain version's order
        short = members <= segsum.SEQUENTIAL_ROWS
        check(torch.equal(k1[short], plain[short]),
              f"B2 {name}: a run of up to {segsum.SEQUENTIAL_ROWS} rows differs from plain")
        err = float((k1 - plain).abs().max()) if k1.numel() else 0.0
        print(f"phase 4: segsum {name}: N={vals.shape[0]} W={vals.shape[1]} segments "
              f"{int(live.sum())} ({int((live & ~short).sum())} longer than "
              f"{segsum.SEQUENTIAL_ROWS} rows), two launches bitwise equal, max "
              f"|kernel - plain| {err:.3e}", flush=True)
        return err

    n_main = SCAN_CAPACITY
    errs = [
        case("ragged N", *segments(100_003, 4, 0.3, 0.9, 100_003)),
        case("one segment of all rows", *segments(n_main, 4, 0.0, 1.0, n_main)),
        case("every row its own segment", *segments(n_main, 4, 1.0, 1.0, n_main)),
        case("no valid row", *segments(5000, 4, 0.3, 0.0, 5000)),
        case("N = 0", *segments(0, 4, 0.3, 1.0, 0)),
        case("W = 1, tail 2**28", *segments(7777, 1, 0.5, 0.8, 2 ** 28)),
        case("W = 7, tail 2**28", *segments(7777, 7, 0.5, 0.8, 2 ** 28)),
        case("W = 131", *segments(7777, 131, 0.5, 0.8, 7777)),
        case("runs of ~500 rows", *segments(n_main, 4, 0.002, 1.0, n_main)),
        case("runs of ~500 rows, W = 7", *segments(50_000, 7, 0.002, 0.95, 50_000)),
    ]
    # runs of one row less, as many, and one more than a thread adds alone
    L = segsum.SEQUENTIAL_ROWS
    lengths = np.tile([L - 1, L, L + 1], 200)
    seg = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    vals = rng.normal(size=(len(seg), 4)).astype(np.float32)
    errs.append(case(f"runs of {L - 1}, {L}, {L + 1} rows",
                     torch.from_numpy(vals).to(dev), torch.from_numpy(seg).to(dev)))
    # ids that skip (callers make none): the rows of the gaps are 0
    steps = ((rng.random(10_000) < 0.2) * rng.integers(1, 4, 10_000)).astype(np.int32)
    steps[0] = 2
    seg = np.cumsum(steps).astype(np.int32)
    seg[9000:] = 2 ** 28
    vals = rng.normal(size=(10_000, 4)).astype(np.float32)
    errs.append(case("gaps between ids", torch.from_numpy(vals).to(dev),
                     torch.from_numpy(seg).to(dev)))
    one_vals, one_seg = segments(n_main, 4, 0.0, 1.0, n_main)
    one_ms = cuda_ms(lambda: segsum.segment_sum_sorted(one_vals, one_seg), reps=3)

    far_cloud = far_voxels_on_card(segsum)
    errs.append(case("past 2^30 cells (three-key sort)",
                     *main_path_segments(segsum, far_cloud, FAR_LEAF)[:2]))
    vals, seg, n_vox = main_path_segments(
        segsum, from_numpy(scan0, capacity=SCAN_CAPACITY), LEAF)
    errs.append(case("main path (scan 0, leaf 0.2)", vals, seg))
    for bad, why in ((lambda: segsum.segment_sum_sorted(vals.double(), seg), "float64"),
                     (lambda: segsum.segment_sum_sorted(vals, seg.long()), "int64 ids"),
                     (lambda: segsum.segment_sum_sorted(vals.t().contiguous().t(), seg),
                      "non-contiguous")):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"segsum wrapper accepted {why}")

    # torch.segment_reduce computes the same sums from segment lengths (the
    # invalid tail as one more segment); timed as the yardstick only
    lengths = torch.bincount(torch.clamp(seg, max=n_vox), minlength=n_vox + 1)
    lib_out = torch.segment_reduce(vals, "sum", lengths=lengths)
    check(bool((lib_out[:n_vox] - segsum.segment_sum_sorted_plain(vals, seg)[:n_vox])
               .abs().max() <= 1e-3), "segment_reduce does not compute the same sums")
    ms = cuda_ms(lambda: segsum.segment_sum_sorted(vals, seg), reps=200)
    plain_ms = cuda_ms(lambda: segsum.segment_sum_sorted_plain(vals, seg), reps=20)
    library_ms = cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths), reps=20)
    bound_s, bound_by = segsum_bound_ms(vals.shape[0], vals.shape[1], n_vox)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            segsum.segment_sum_sorted(vals, seg)
        torch.cuda.synchronize()
    device_us = {}
    for e in prof.key_averages():
        name = re.search(r"segsum\w*_kernel", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            device_us[name.group(0)] = e.self_device_time_total / e.count
    print(f"phase 4: segsum device time per launch (profiler): "
          + (", ".join(f"{k} {v:.2f} us" for k, v in device_us.items()) or "not measured"),
          flush=True)
    noop = segsum.launch_floor()
    floor_ms = cuda_ms(noop, reps=500)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        noop()
    floor_host = (time.perf_counter() - t0) / 500
    torch.cuda.synchronize()
    print(f"phase 4: launch floor: an empty kernel through the same ctypes path "
          f"{floor_ms * 1e3:.1f} us per call (CUDA events), {floor_host * 1e6:.1f} us of host "
          f"time per call [{card_line()}]", flush=True)
    print(f"phase 4: segsum kernel {ms * 1e3:.1f} us per call at N={vals.shape[0]} "
          f"W={vals.shape[1]} ({n_vox} voxels), plain {plain_ms * 1e3:.1f} us, "
          f"torch.segment_reduce {library_ms * 1e3:.1f} us, bound {bound_s * 1e6:.2f} us "
          f"({bound_by}); one segment of {n_main} rows {one_ms:.3f} ms [{card_line()}]",
          flush=True)
    return {"name": "segsum", "route": "cuda", "source": "pcl_tpu_torch/csrc/segsum.cu",
            "replaces": "pcl_tpu/ops/pallas_segsum.py:38", "launches": None,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "library_ms": library_ms}


def front_end(raw, log=None):
    """voxel_downsample (kernel B2) and estimate_normals for each scan, then
    point-to-plane odometry_sequence. Returns (clouds, poses, [(ICP result,
    seconds)]); with ``log``, prints each stage's time."""
    from pcl_tpu_torch import features, filters, search
    from pcl_tpu_torch.registration import icp as icp_mod
    from pcl_tpu_torch.registration import trajectory

    clouds = []
    for i, cloud in enumerate(raw):
        ds, t_ds = timed(lambda: filters.voxel_downsample(cloud, LEAF))
        probe, t_probe = timed(lambda: search.auto_cell_params(ds, NORMAL_K))
        # estimate_normals runs the same host probe again inside
        nc, t_n = timed(lambda: features.estimate_normals(ds, k=NORMAL_K))
        clouds.append(nc)
        if log:
            print(f"{log}: scan {i}: {int(ds.mask.sum())} voxels; downsample "
                  f"{t_ds * 1e3:.3f} ms, normals {t_n * 1e3:.3f} ms (of it the host probe "
                  f"{t_probe * 1e3:.3f} ms: cell {probe[0]:.4f} m, cap {probe[1]})", flush=True)
    results = []

    def register(s, t):
        res, secs = timed(lambda: icp_mod.icp(s, t, **ICP_KW))
        results.append((res, secs))
        return res

    poses = trajectory.odometry_sequence(clouds, register=register)
    return clouds, poses, results


def phase5_path_c(segsum, nn1_mod, scans, golden, record):
    """Path C: the odometry front end at KITTI scan size."""
    from pcl_tpu_torch import features, filters, search
    from pcl_tpu_torch.core import geometry
    from pcl_tpu_torch.core.cloud import Cloud, from_numpy
    from pcl_tpu_torch.registration import icp as icp_mod
    from pcl_tpu_torch.registration import trajectory

    raw = [from_numpy(s, capacity=SCAN_CAPACITY) for s in scans]
    warm = [features.estimate_normals(filters.voxel_downsample(c, LEAF), k=NORMAL_K)
            for c in raw[:2]]
    icp_mod.icp(warm[1], warm[0], **dict(ICP_KW, max_iterations=2))      # warm-up

    segsum.segment_sum_sorted.launches = 0
    nn1_mod.nn1.launches = 0
    (clouds, poses, results), secs = timed(lambda: front_end(raw, log="phase 5"))
    launches = segsum.segment_sum_sorted.launches
    record["launches"] = launches
    print(f"phase 5: path C {N_SCANS} scans in {secs * 1e3:.1f} ms; segsum launches "
          f"{launches}, nn1 launches {nn1_mod.nn1.launches}", flush=True)
    check(launches == N_SCANS, f"segsum launched {launches} times for {N_SCANS} scans")
    for k, (res, t) in enumerate(results):
        it = int(res.iterations)
        print(f"phase 5: pair {k + 1}->{k}: ICP {t * 1e3:.3f} ms, {it} iterations "
              f"({t * 1e3 / max(it, 1):.3f} ms per iteration), code "
              f"{int(res.convergence_state)}, truncated {bool(res.truncated)}, "
              f"correspondences {int(res.num_correspondences)}, fitness "
              f"{float(res.fitness):.6f} [{card_line()}]", flush=True)
        check(bool(res.converged), f"path C pair {k + 1} did not converge")
        check(not bool(res.truncated), f"path C pair {k + 1} truncated: raise cell_cap")
    ate = trajectory.trajectory_ate(poses, golden, align=False)
    rpe = trajectory.trajectory_rpe(poses, golden)
    print(f"phase 5: ATE (unaligned) rmse {ate.rmse:.6f} m, max {ate.max:.6f} m; RPE "
          f"{rpe.trans_rmse:.6f} m, {rpe.rot_rmse:.3e} rad per step", flush=True)
    check(ate.rmse <= 0.03, f"path C ATE {ate.rmse} m over 0.03 m")
    device_breakdown("phase 5 (one ICP pair)",
                     lambda: icp_mod.icp(clouds[1], clouds[0], **ICP_KW))

    # scan 0 of the main path against the port's CPU run: the downsample
    # (B2 on the card, its plain version on the CPU) of the same raw scan ...
    ds = clouds[0]
    ds_cpu = filters.voxel_downsample(from_numpy(scans[0], capacity=SCAN_CAPACITY,
                                                 device="cpu"), LEAF)
    check(torch.equal(ds.mask.cpu(), ds_cpu.mask), "scan 0: live voxels differ from the CPU run")
    extent = float(np.abs(scans[0]).max())
    derr = float((ds.xyz.cpu() - ds_cpu.xyz).abs().max())
    check(derr <= 1e-5 * extent, f"scan 0: centroids differ from the CPU run by {derr} m")
    # ... and the normals of the card's cloud, on the CPU for 8192 voxels
    surf_cpu = Cloud(xyz=ds.xyz.cpu(), mask=ds.mask.cpu())
    cell, cap = search.auto_cell_params(surf_cpu, NORMAL_K)
    live = torch.nonzero(surf_cpu.mask)[:, 0]
    sub = live[:: max(1, len(live) // 8192)][:8192]
    query = surf_cpu.take(sub)
    on_cpu = features.estimate_normals(query, k=NORMAL_K, surface=surf_cpu, backend="cell",
                                       cell_size=cell, cell_cap=cap)
    n_card = ds.attrs["normal"].cpu()[sub]
    c_card = ds.attrs["curvature"].cpu()[sub]
    idx, d2n, valid = search.knn(surf_cpu, query.xyz, NORMAL_K + 1, backend="cell",
                                 cell_size=cell, cell_cap=cap)
    # A voxel whose 16th and 17th neighbours are equally far to float32
    # rounding has no one neighbourhood: which of the two a device takes
    # depends on how it rounds a squared distance (1e-5 of it at 60 m range),
    # and the host's CPU type decides that for the CPU run. Such voxels
    # (about one in a thousand) are counted and left out of the comparison.
    firm = (d2n[:, NORMAL_K] - d2n[:, NORMAL_K - 1]) > 1e-4 * d2n[:, NORMAL_K]
    idx, valid = idx[:, :NORMAL_K], valid[:, :NORMAL_K]
    nbr = surf_cpu.xyz[torch.clamp(idx.long(), 0, surf_cpu.capacity - 1)]
    _, cov, _ = geometry.mean_and_covariance(nbr, valid)
    lam = np.linalg.eigvalsh(cov.double().numpy())
    # eigenvectors are compared where lambda1 - lambda0 > 1e-3 lambda2, with
    # their sign (after the viewpoint flip); curvature to 1e-5 where all
    # eigenvalues are 1e-2 of lambda2 apart, 5e-4 elsewhere (the closed
    # form's arccos loses accuracy as two eigenvalues meet: the poles' thin
    # neighbourhoods)
    well = torch.from_numpy(lam[:, 1] - lam[:, 0] > 1e-3 * lam[:, 2]) & firm
    apart = torch.from_numpy(np.min(np.diff(lam, axis=1), axis=1) > 1e-2 * lam[:, 2])
    dots = (n_card * on_cpu.attrs["normal"]).sum(1)
    cerr = (c_card - on_cpu.attrs["curvature"]).abs()
    print(f"phase 5: scan 0 card vs CPU: {int(ds.mask.sum())} voxels equal, max |centroid "
          f"diff| {derr:.3e} m; normals of {len(sub)} voxels ({int((~firm).sum())} left out: "
          f"16th and 17th neighbour tie): min n.n' {float(dots[well].min()):.8f} "
          f"on {int(well.sum())} well-conditioned, max |curvature diff| "
          f"{float(cerr[apart & firm].max()):.3e} ({int((apart & firm).sum())} separated), "
          f"{float(cerr[firm].max()):.3e} (all)", flush=True)
    check(int((~firm).sum()) <= len(sub) // 100, "scan 0: too many neighbour ties left out")
    check(bool((dots[well] >= 1 - 1e-5).all()), "scan 0: normals differ from the CPU run")
    check(bool((cerr <= torch.where(apart, 1e-5, 5e-4))[firm].all()),
          "scan 0: curvature differs from the CPU run")

    # the whole chain with the plain segment sum on the card
    kernel_segsum = segsum.segment_sum_sorted
    segsum.segment_sum_sorted = segsum.segment_sum_sorted_plain
    try:
        _, plain_poses, plain_results = front_end(raw)
    finally:
        segsum.segment_sum_sorted = kernel_segsum
    pdiff = float(np.abs(plain_poses[:, :3, 3] - poses[:, :3, 3]).max())
    print(f"phase 5: chain with the plain segment sum: iterations "
          f"{[int(r.iterations) for r, _ in plain_results]} against "
          f"{[int(r.iterations) for r, _ in results]}, max |t - t_kernel| {pdiff:.3e} m",
          flush=True)
    check(pdiff <= 1e-4, f"plain-segsum chain poses differ by {pdiff} m")
    n_pairs = max(len(results), 1)
    return sum(t for _, t in results) * 1e3 / n_pairs, ate.rmse


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import pcl_tpu_torch  # noqa: F401  (sets full-float32 matmuls)
    from pcl_tpu_torch.ops import _build
    from pcl_tpu_torch.ops import nn1 as nn1_mod
    from pcl_tpu_torch.ops import segsum
    from pcl_tpu_torch.registration import trajectory

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
    t0 = time.perf_counter()
    scans, golden = trajectory.make_virtual_scan_sequence(
        make_street(), N_SCANS, np.random.default_rng(0), **SEQUENCE_KW)
    print(f"set-up: street of {SCENE_POINTS} points, {N_SCANS} scans of "
          f"{[len(s) for s in scans]} points in {time.perf_counter() - t0:.1f} s", flush=True)

    src, tgt, M = make_pair(N_POINTS)
    record = phase1_nn1(nn1_mod, src, tgt)
    ms_a = phase2_path_a(nn1_mod, src, tgt, M, record)
    ms_b = phase3_path_b(src, tgt, M)
    record_b2 = phase4_segsum(segsum, scans[0])
    ms_pair, ate = phase5_path_c(segsum, nn1_mod, scans, golden, record_b2)
    print(f"summary: path A {ms_a:.3f} ms/iteration, path B {ms_b:.3f} ms/iteration, "
          f"path C {ms_pair:.3f} ms per ICP pair, ATE {ate:.6f} m; nn1 {record['ms']:.3f} "
          f"ms/sweep (bound {record['bound_ms']:.3f} ms, plain {record['plain_ms']:.1f} ms); "
          f"segsum {record_b2['ms'] * 1e3:.1f} us (bound {record_b2['bound_ms'] * 1e3:.2f} us, "
          f"plain {record_b2['plain_ms'] * 1e3:.1f} us, library "
          f"{record_b2['library_ms'] * 1e3:.1f} us) [{card}]", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [record, record_b2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
