"""A/B of ``core.transforms.from_rt`` on the card: path C's ICP pair and
path G's KinFu frames (``chip_smoke.py`` phases 5 and 9, cut to the pair
1->0 and the first 12 frames) with three builds of the 4x4 matrix,
alternating in one process:

- ``in_place``: a zero matrix written in place (the build before the
  Levenberg-Marquardt warps needed ``torch.func`` to trace it);
- ``host_row``: the bottom row copied from a host list (a pageable copy,
  which synchronises the stream on every call);
- ``device_row``: the bottom row from ``torch.eye`` on the device (the
  package's).

``se3_exp`` and ``invert_rigid`` call ``from_rt`` through the module, so
replacing ``transforms.from_rt`` changes every ICP and KinFu iteration.

    python tests/ab_from_rt.py [rounds]

Prints, per build, the ICP pair's ms per iteration and KinFu's median ms
per frame in each round, the stream synchronisations of one ICP pair and
one KinFu step, and whether the results are bitwise the package build's.
Needs one CUDA device."""

import os
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def in_place(R, t):
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def host_row(R, t):
    t = t.to(R.dtype).expand(R.shape[:-2] + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom = bottom + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom], dim=-2)


def syncs(fn) -> int:
    """The stream synchronisations ``fn`` makes, as PyTorch's sync debug
    mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen)


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_from_rt: no CUDA device", file=sys.stderr)
        return 2
    import pcl_tpu_torch  # noqa: F401  (sets full-float32 matmuls)
    from pcl_tpu_torch import features, filters
    from pcl_tpu_torch.core import transforms
    from pcl_tpu_torch.core.cloud import from_numpy
    from pcl_tpu_torch.fusion import Intrinsics, kinfu_init, kinfu_step, make_volume
    from pcl_tpu_torch.registration import trajectory
    from pcl_tpu_torch.registration.icp import icp

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    n_frames = 12
    card = cs.card_line()
    print(card, flush=True)
    builds = {"in_place": in_place, "host_row": host_row, "device_row": transforms.from_rt}

    street = cs.make_street()
    scans, _ = trajectory.make_virtual_scan_sequence(
        street, cs.N_SCANS, np.random.default_rng(0), **cs.SEQUENCE_KW)
    clouds = [features.estimate_normals(filters.voxel_downsample(
        from_numpy(s, capacity=cs.SCAN_CAPACITY), cs.LEAF), k=cs.NORMAL_K) for s in scans[:2]]

    intr = Intrinsics(*cs.G_INTR)
    H, W = cs.G_SHAPE
    rng = np.random.default_rng(cs.G_SEED)
    golden = cs.handheld(rng, cs.G_FRAMES)
    frames = [cs.render_depth(P, intr, H, W, rng)[0] for P in golden[:n_frames]]
    start = torch.from_numpy(golden[0]).float().cuda()

    def icp_pair():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp(clouds[1], clouds[0], **cs.ICP_KW)
        it = int(res.iterations)
        return res.transform, (time.perf_counter() - t0) * 1e3 / it, it

    def kinfu_run(res=cs.G_RES):
        s = kinfu_init(make_volume(res, cs.G_SIZE, origin=cs.G_ORIGIN), H, W, start)
        ms = []
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = kinfu_step(s, torch.from_numpy(f).cuda(), intr)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return s.pose, float(np.median(ms[1:]))

    for fn in builds.values():                           # warm-up
        transforms.from_rt = fn
        icp(clouds[1], clouds[0], **dict(cs.ICP_KW, max_iterations=2))
        kinfu_run(64)
    names = list(builds)
    rows = {n: {"icp": [], "kinfu": []} for n in names}
    out = {}
    for r in range(rounds):
        order = names[r % 3:] + names[:r % 3]
        for n in order:
            transforms.from_rt = builds[n]
            T, ms_it, it = icp_pair()
            pose, ms_frame = kinfu_run()
            rows[n]["icp"].append(ms_it)
            rows[n]["kinfu"].append(ms_frame)
            out[n] = (T, it, pose)
            torch.cuda.empty_cache()
        print(f"round {r}: " + "; ".join(
            f"{n} {rows[n]['icp'][-1]:.3f} ms/iteration, {rows[n]['kinfu'][-1]:.1f} ms/frame"
            for n in names), flush=True)
    ref = out["device_row"]
    for n in names:
        transforms.from_rt = builds[n]
        s = kinfu_init(make_volume(64, cs.G_SIZE, origin=cs.G_ORIGIN), H, W, start)
        s = kinfu_step(s, torch.from_numpy(frames[0]).cuda(), intr)
        f1 = torch.from_numpy(frames[1]).cuda()
        n_kinfu = syncs(lambda: kinfu_step(s, f1, intr))
        n_icp = syncs(lambda: icp(clouds[1], clouds[0], **cs.ICP_KW))
        T, it, pose = out[n]
        same = torch.equal(T, ref[0]) and torch.equal(pose, ref[2])
        print(f"{n}: ICP pair 1->0 {it} iterations, ms per iteration median "
              f"{np.median(rows[n]['icp']):.3f} (min {min(rows[n]['icp']):.3f}, max "
              f"{max(rows[n]['icp']):.3f}); KinFu {n_frames} frames at {cs.G_RES}^3, median ms "
              f"per frame {np.median(rows[n]['kinfu']):.1f} (rounds {min(rows[n]['kinfu']):.1f}-"
              f"{max(rows[n]['kinfu']):.1f}); synchronisations: ICP pair {n_icp}, KinFu step "
              f"{n_kinfu}; bitwise the device_row results {same} [{card}]", flush=True)
    transforms.from_rt = builds["device_row"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
