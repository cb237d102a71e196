"""Scan-to-scan GICP odometry over a drive of the street (cell ``odom-gicp``).

Set-up draws the traffic's drive (its poses fixed by ``walk_seed``) and ray
casts its scans on the card as the configuration's sensor sees the street,
each scan's starting azimuth and range noise drawn from the seed, then runs
the flow on the drive's first three scans to warm up. A unit is one scan
through the flow of ``pcl_tpu_torch.tools.odometry``:
``filters.voxel_downsample``, then ``tools.odometry.probed_cells`` and
``registration.gicp`` against the previous scan's voxels, from the identity.
The unit ends when the pose has been read back and chained onto the last one
(``odometry_sequence``'s convention). At the end of the drive a new chain
starts at its first scan, which registers nothing and is not counted.

The check (``verify``) takes a run of consecutive pairs drawn from the seed
among the first ones of the window and holds, against the plain reference of
``benchmark/reference/geometry.py`` in float64: each scan's voxels against the
raw scan's centroids; each pose against the reference aligner's, the same
algorithm with the same stopping rule from the same start on the port's
voxels; the chained pose over the run against the chained
reference poses. Poses are compared across the street and up (x, y) and along
it (z) apart.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from benchmark.reference import geometry as ref
from benchmark.reference import search
from benchmark.scenes import street


class State:
    pass


def setup(run) -> State:
    from pcl_tpu_torch.core.cloud import make_cloud

    cfg, tr = run.config, run.traffic
    dev = run.device
    st = State()
    gen = street.generator(run.seed, dev)
    rng = np.random.default_rng(run.seed % 2 ** 64)
    # the drive's geometry is the traffic's (every seed registers the same
    # motions); the seed draws each scan's starting azimuth and range noise
    # and the checked pairs
    drive = {k: v for k, v in tr["drive"].items() if k not in ("source", "walk_seed")}
    st.poses = street.drive_poses(np.random.default_rng(tr["drive"]["walk_seed"]), **drive)
    sensor = cfg["sensor"]
    el = torch.as_tensor(street.ring_elevations(sensor["rings"]), dtype=torch.float64,
                         device=dev)
    st.scans = [street.hdl64_scan(P, el, sensor, gen, cfg["scene"]["alleys"])
                for P in st.poses]
    st.clouds = [make_cloud(s, device=dev) for s in st.scans]
    sizes = sorted(len(s) for s in st.scans)
    print(f"benchmark: {len(sizes)} scans of {sizes[0]}-{sizes[-1]} points "
          f"(median {sizes[len(sizes) // 2]})", file=sys.stderr)
    # the checked run of pairs: scans s-1 .. s+pairs-1, among the drive's
    # first ``within`` scans
    chk = run.cell["check"]
    s = int(rng.integers(1, chk["within"] - chk["pairs"] + 1))
    st.check_scans = list(range(s - 1, s + chk["pairs"]))
    st.kept = {}
    # warm-up: the flow on the drive's first three scans (two pairs)
    st.pos, st.prev, st.chain = 0, None, np.eye(4)
    for _ in range(3):
        _unit(st, run, keep=False)
    st.pos, st.prev, st.chain = 0, None, np.eye(4)
    run.sync()
    return st


def _unit(st: State, run, keep: bool) -> dict:
    from pcl_tpu_torch import filters
    from pcl_tpu_torch.registration import gicp
    from pcl_tpu_torch.tools.odometry import probed_cells

    tr = run.traffic
    i = st.pos
    st.pos = (i + 1) % len(st.clouds)
    raw = st.clouds[i]
    with run.span("downsample"):
        ds = filters.voxel_downsample(raw, tr["leaf"])
    if keep and i in st.check_scans:
        st.kept[i] = {"voxels": ds}
    if i == 0:
        # the first scan of a chain registers nothing
        st.prev, st.chain = ds, np.eye(4)
        run.sync()
        return {"counted": False, "scan": i}
    prev = st.prev
    gate = tr["max_corr_dist"]
    with run.span("probe"):
        kw = probed_cells(ds, prev, "gicp", gate)
    with run.span("aligner"):
        res = gicp(ds, prev, max_corr_dist=gate, max_iterations=tr["max_iterations"],
                   inner_iterations=tr["inner_iterations"],
                   transformation_eps=tr["transformation_eps"],
                   k_covariances=tr["k_covariances"], **kw)
    flags = [res.iterations.to(torch.float64).reshape(1),
             res.truncated.to(torch.float64).reshape(1)]
    # the one read-back that closes the unit
    out = torch.cat([res.transform.to(torch.float64).reshape(16)] + flags).cpu().numpy()
    T = out[:16].reshape(4, 4)
    st.chain = st.chain @ T
    st.prev = ds
    if keep and i in st.check_scans:
        st.kept[i].update(T=T, iterations=int(out[16]))
    failed = (not np.isfinite(T).all()) or bool(out[17])
    return {"counted": True, "scan": i, "iterations": int(out[16]), "failed": failed}


def unit(st: State, run) -> dict:
    return _unit(st, run, keep=True)


def release(st: State) -> None:
    """Drop the port's state but what the check reads."""
    st.prev = None
    st.clouds = None


# ------------------------------------------------------------------ the check

def _voxel_gap(a: torch.Tensor, b: torch.Tensor, leaf: float) -> float:
    """The largest distance from a centroid of either set to the nearest of
    the other (inf where none lies within a voxel's width)."""
    if len(a) == 0 or len(b) == 0:
        return math.inf if len(a) + len(b) else 0.0
    _, d_ab = search.nn1_within(b, a, leaf)
    _, d_ba = search.nn1_within(a, b, leaf)
    return math.sqrt(float(torch.maximum(d_ab.max(), d_ba.max())))


def verify(st: State, run, control: bool = False) -> dict:
    """The numbers compared, each ``(value, limit)``. With ``control`` the
    port's outputs are replaced by the reference's computed in bfloat16."""
    tr, lim, chk = run.traffic, run.cell["limits"], run.cell["check"]
    f64, low = torch.float64, torch.bfloat16
    leaf, gate, k = tr["leaf"], tr["max_corr_dist"], tr["k_covariances"]
    scans = [j for j in st.check_scans if j in st.kept]
    vox = {}
    count_gap, vox_gap = 0.0, 0.0
    for j in scans:
        raw = st.scans[j]
        ref_v = ref.voxel_centroids(raw, leaf, f64)
        if control:
            vox[j] = ref.voxel_centroids(raw, leaf, low).to(f64)
        else:
            ds = st.kept[j]["voxels"]
            vox[j] = ds.xyz[ds.mask].to(f64)
        count_gap = max(count_gap, float(abs(len(vox[j]) - len(ref_v))))
        vox_gap = max(vox_gap, _voxel_gap(vox[j], ref_v, leaf))
    pose_xy, pose_z, pose_r = 0.0, 0.0, 0.0
    chain_p = torch.eye(4, dtype=f64)
    chain_r = torch.eye(4, dtype=f64)
    n_pairs = 0
    for j in scans[1:]:
        if j - 1 not in vox or "T" not in st.kept[j]:
            continue
        src, tgt = vox[j], vox[j - 1]
        eye = torch.eye(4, dtype=f64, device=src.device)

        def align(dt):
            """The reference aligner in ``dt`` from the identity: its pose and
            iterations, and its covariances."""
            cs = ref.gicp_covariances(src.to(dt), k, chk["knn_cell"])
            ct = ref.gicp_covariances(tgt.to(dt), k, chk["knn_cell"])
            T, its = ref.gicp(src.to(dt), tgt.to(dt), cs, ct, eye.to(dt), gate,
                              tr["max_iterations"], tr["inner_iterations"],
                              tr["transformation_eps"])
            return T.to(f64).cpu(), its, cs, ct

        T_ref, its_ref, cs, ct = align(f64)
        if control:
            T_prog, its_prog = align(low)[:2]
        else:
            T_prog, its_prog = torch.from_numpy(st.kept[j]["T"]), st.kept[j]["iterations"]
        c_ref = ref.gicp_cost(src, tgt, cs, ct, T_ref.to(src.device), gate)
        c_prog = ref.gicp_cost(src, tgt, cs, ct, T_prog.to(src.device), gate)
        d = (T_prog[:3, 3] - T_ref[:3, 3]).abs()
        xy, z = float(torch.hypot(d[0], d[1])), float(d[2])
        r_gap = ref.pose_gap(T_prog, T_ref)[1]
        print(f"reading: pair {j - 1}->{j}: pose gap across and up {xy:.6g} m, along "
              f"{z:.6g} m, {r_gap:.6g} rad; iterations {its_prog} (reference {its_ref}); "
              f"the reference's objective at the port's pose "
              f"exceeds its own optimum by {(c_prog - c_ref) / abs(c_ref):.3g} of it",
              file=sys.stderr)
        pose_r, pose_xy, pose_z = max(pose_r, r_gap), max(pose_xy, xy), max(pose_z, z)
        chain_p, chain_r = chain_p @ T_prog, chain_r @ T_ref
        n_pairs += 1
    chain = (chain_p[:3, 3] - chain_r[:3, 3]).abs()
    readings = {"voxel_count_gap": count_gap, "voxel_gap_m": vox_gap,
                "pose_gap_xy_m": pose_xy, "pose_gap_z_m": pose_z, "pose_gap_rad": pose_r,
                "chain_gap_xy_m": float(torch.hypot(chain[0], chain[1])),
                "chain_gap_z_m": float(chain[2])}
    return select(readings, lim, chk["pairs"] - n_pairs)


def select(readings: dict, limits: dict, missing: int) -> dict:
    """The numbers this cell compares (those its file gives a limit), each
    ``(value, limit)``, and how many checked units are missing (limit 0).
    The others are printed as readings."""
    checks = {}
    for k, v in readings.items():
        if k in limits:
            checks[k] = (v, limits[k])
        else:
            print(f"reading: {k} {v:.9g} (not compared)", file=sys.stderr)
    checks["pairs_missing"] = (float(missing), 0.0)
    return checks
