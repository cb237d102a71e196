"""CPU rehearsal of ``chip_smoke.py`` path H (phase 10): the featureless
global aligners, PPF and the ICP variants of the JAX package and of the port
on path E's scan pair (and on the street with alleys, cut the same way), at
full width, to set path H's limits before it runs on the card.

    python tests/rehearse_path_h.py fronts OUT_DIR      # both pairs' voxels
    python tests/rehearse_path_h.py jax OUT_DIR [PAIR [SETTINGS]]   # the JAX aligners
    python tests/rehearse_path_h.py port OUT_DIR [PAIR [SETTINGS]]  # the port's, CPU
    python tests/rehearse_path_h.py local OUT_DIR       # (f), (g), (i) with JAX
    python tests/rehearse_path_h.py port_local OUT_DIR  # the same with the port

``fronts`` runs path E's front end (ground RANSAC, 0.3 m voxels, normals,
FPFH) with the port on the CPU and saves the voxels; the other two run the
aligners at the JAX package's defaults, or with the keywords that SETTINGS
(JSON: aligner letter to keywords, e.g. '{"d": {"delta": 0.3}}') gives only
those aligners, and refine each
result with point-to-plane ICP under path E's limits, and print what is left
of the motion across the street and up, along it, and in rotation. Not a test:
pytest does not collect it. It needs both packages and takes tens of minutes.
"""

import json
import math
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PAIRS = ("street", "alleys")


def _pair_scans(name):
    scene = cs.make_street() if name == "street" else cs.make_street(cs.ALLEY_SEED, alleys=True)
    rng = np.random.default_rng(cs.E_SEED)
    P = cs.pose_matrix(*cs.E_POSE)
    return [cs.scan_at(scene, np.eye(4), rng), cs.scan_at(scene, P, rng)], P


def fronts(out):
    from pcl_tpu_torch.core.cloud import make_cloud

    torch.cuda.synchronize = lambda: None
    os.makedirs(out, exist_ok=True)
    for name in PAIRS:
        scans, P = _pair_scans(name)
        arrays = {"P": P}
        k = None
        for i, s in enumerate(scans):
            nc, f, _, k, _ = cs.global_front(make_cloud(s, device="cpu"), k=k)
            arrays[f"xyz{i}"] = nc.xyz.numpy()
            arrays[f"normal{i}"] = nc.attrs["normal"].numpy()
            arrays[f"curv{i}"] = nc.attrs["curvature"].numpy()
            arrays[f"fpfh{i}"] = f.numpy()
            arrays[f"raw{i}"] = s
        np.savez(os.path.join(out, f"{name}.npz"), **arrays)
        print(f"{name}: voxels {len(arrays['xyz0'])} / {len(arrays['xyz1'])}, FPFH k {k}",
              flush=True)


def residual(T, P):
    """Across the street and up (m), along it (m), rotation (rad)."""
    T = np.asarray(T, np.float64)
    d = T[:3, 3] - P[:3, 3]
    R = T[:3, :3] @ P[:3, :3].T
    ang = math.acos(max(-1.0, min(1.0, 0.5 * (np.trace(R) - 1))))
    return round(math.hypot(d[0], d[1]), 6), round(abs(d[2]), 6), round(ang, 6)


def _only(settings):
    """The aligners to run and their keywords."""
    return dict(settings) if settings else {k: {} for k in "abcde"}


def jax_run(out, pairs, settings=None):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from pcl_tpu.core.cloud import Cloud
    from pcl_tpu.registration import fpcs, icp as _icp, ppf, variants  # noqa: F401
    from pcl_tpu.keypoints.iss import iss3d_keypoints
    import importlib
    jicp = importlib.import_module("pcl_tpu.registration.icp")

    for name in pairs:
        z = np.load(os.path.join(out, f"{name}.npz"))
        P = z["P"]
        tgt, src = (Cloud(xyz=jnp.asarray(z[f"xyz{i}"]), mask=jnp.ones(len(z[f"xyz{i}"]), bool),
                          attrs={"normal": jnp.asarray(z[f"normal{i}"])}) for i in (0, 1))
        kp = {}
        for tag, c in (("src", src), ("tgt", tgt)):
            m, _ = iss3d_keypoints(c, cs.H_SALIENT, 0.5 * cs.H_SALIENT, density_weights=True)
            kp[tag] = Cloud(xyz=c.xyz, mask=m)
        print(f"{name}: ISS keypoints {int(kp['src'].mask.sum())} / {int(kp['tgt'].mask.sum())}",
              flush=True)
        kw = _only(settings)
        runs = {
            "a fpcs": lambda: fpcs.fpcs_align(src, tgt, **kw["a"]),
            "b kfpcs": lambda: fpcs.kfpcs_align(src, tgt, salient_radius=cs.H_SALIENT, **kw["b"]),
            "c fpcs4": lambda: fpcs.fpcs4_align(src, tgt, **kw["c"]),
            "d fpcs4_host": lambda: fpcs.fpcs4_align_host(
                Cloud(xyz=jnp.asarray(np.asarray(src.xyz)[np.asarray(kp["src"].mask)]),
                      mask=jnp.ones(int(kp["src"].mask.sum()), bool)),
                Cloud(xyz=jnp.asarray(np.asarray(tgt.xyz)[np.asarray(kp["tgt"].mask)]),
                      mask=jnp.ones(int(kp["tgt"].mask.sum()), bool)), **kw["d"]),
            "e ppf": lambda: ppf.ppf_register(src, tgt, **kw["e"]),
        }
        for tag, run in runs.items():
            if tag[0] not in kw:
                continue
            t0 = time.perf_counter()
            res = run()
            T = np.asarray(res.transform)
            secs = time.perf_counter() - t0
            ref = jicp.icp(src, tgt, init_transform=jnp.asarray(T, jnp.float32),
                           variant="point_to_plane", **cs.E_ICP_KW)
            print(json.dumps({"pair": name, "aligner": tag, "s": round(secs, 1),
                              "global": residual(T, P),
                              "p2plane": residual(np.asarray(ref.transform), P),
                              "score": float(getattr(res, "error", getattr(res, "votes", 0)))}),
                  flush=True)


def port_run(out, pairs, settings=None):
    from pcl_tpu_torch.core.cloud import Cloud
    from pcl_tpu_torch.registration import fpcs, icp, ppf

    for name in pairs:
        z = np.load(os.path.join(out, f"{name}.npz"))
        P = z["P"]
        tgt, src = (Cloud(xyz=torch.from_numpy(z[f"xyz{i}"]),
                          mask=torch.ones(len(z[f"xyz{i}"]), dtype=torch.bool),
                          attrs={"normal": torch.from_numpy(z[f"normal{i}"])}) for i in (0, 1))
        ks, kt = fpcs.kfpcs_keypoints(src, tgt, cs.H_SALIENT)
        kw = _only(settings)
        runs = {
            "a fpcs": lambda: fpcs.fpcs_align(src, tgt, **kw["a"]),
            "b kfpcs": lambda: fpcs.kfpcs_align(src, tgt, salient_radius=cs.H_SALIENT, **kw["b"]),
            "c fpcs4": lambda: fpcs.fpcs4_align(src, tgt, **kw["c"]),
            "d fpcs4_host": lambda: fpcs.fpcs4_align_host(cs.live_rows(ks), cs.live_rows(kt),
                                                          **kw["d"]),
            "e ppf": lambda: ppf.ppf_register(src, tgt, **kw["e"]),
        }
        for tag, run in runs.items():
            if tag[0] not in kw:
                continue
            t0 = time.perf_counter()
            res = run()
            secs = time.perf_counter() - t0
            ref = icp(src, tgt, init_transform=res.transform, variant="point_to_plane",
                      **cs.E_ICP_KW)
            print(json.dumps({"pair": name, "aligner": tag, "s": round(secs, 1),
                              "global": residual(res.transform.numpy(), P),
                              "p2plane": residual(ref.transform.numpy(), P)}), flush=True)


def local_run(out):
    """The JAX package's icp_nl on path E's pair from a start 0.3 m and 0.02
    rad off, joint_icp on path C's pair 1 -> 0 split at x = 0, ndt_2d on
    path H's planar scans and its icp2d tool on the first pair."""
    import importlib
    import tempfile

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from pcl_tpu import io as jio
    from pcl_tpu.core.cloud import Cloud
    from pcl_tpu.registration import ndt2d, variants
    from pcl_tpu.tools import icp2d
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.registration import trajectory

    torch.cuda.synchronize = lambda: None

    def jc(xyz, mask=None):
        return Cloud(xyz=jnp.asarray(xyz), mask=jnp.ones(len(xyz), bool) if mask is None
                     else jnp.asarray(mask))

    z = np.load(os.path.join(out, "street.npz"))
    P = z["P"]
    start = P.copy()
    start[:3, 3] += [0.2, 0.0, 0.2]
    a = 0.02
    start[:3, :3] = start[:3, :3] @ np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                                              [-math.sin(a), 0, math.cos(a)]])
    t0 = time.perf_counter()
    r = variants.icp_nl(jc(z["xyz1"]), jc(z["xyz0"]), jnp.asarray(start, jnp.float32),
                        warp="rigid_6d", **cs.E_ICP_KW)
    print(json.dumps({"part": "f icp_nl", "s": round(time.perf_counter() - t0, 1),
                      "start": residual(start, P), "left": residual(np.asarray(r.transform), P),
                      "iterations": int(r.iterations), "code": int(r.convergence_state)}),
          flush=True)

    scans, golden = trajectory.make_virtual_scan_sequence(
        cs.make_street(), cs.N_SCANS, np.random.default_rng(0), **cs.SEQUENCE_KW)
    from pcl_tpu_torch import filters
    vox = [filters.voxel_downsample(make_cloud(s, device="cpu"), cs.LEAF) for s in scans[:2]]
    xyz = [v.xyz[v.mask].numpy() for v in vox]
    halves = [(jc(xyz[1][f(xyz[1][:, 0])]), jc(xyz[0][f(xyz[0][:, 0])]))
              for f in (lambda x: x < 0, lambda x: x >= 0)]
    t0 = time.perf_counter()
    r = variants.joint_icp([h[0] for h in halves], [h[1] for h in halves], **cs.H_JOINT_KW)
    step = np.linalg.inv(golden[0]) @ golden[1]
    E = np.asarray(r.transform, np.float64) @ np.linalg.inv(step)
    print(json.dumps({"part": "g joint_icp", "s": round(time.perf_counter() - t0, 1),
                      "left_m": float(np.linalg.norm(np.asarray(r.transform)[:3, 3] - step[:3, 3])),
                      "left_rad": math.acos(min(1.0, 0.5 * (np.trace(E[:3, :3]) - 1))),
                      "iterations": int(r.iterations), "code": int(r.convergence_state)}),
          flush=True)

    scene = cs.make_street(cs.ALLEY_SEED, alleys=True)
    prng = np.random.default_rng(cs.H_PLANAR_SEED)
    planar = [cs.planar_scan(scene, i, prng) for i in range(cs.H_PLANAR_SCANS)]
    for i in range(1, cs.H_PLANAR_SCANS):
        t0 = time.perf_counter()
        r = ndt2d.ndt_2d(jc(planar[i]), jc(planar[i - 1]), **cs.H_NDT2D_KW)
        d = np.abs(np.asarray(r.params, np.float64) - cs.planar_truth(i))
        print(json.dumps({"part": f"i ndt_2d {i}", "points": len(planar[i]),
                          "s": round(time.perf_counter() - t0, 1),
                          "left_m": float(math.hypot(d[0], d[1])), "left_rad": float(d[2]),
                          "converged": bool(r.converged), "iterations": int(r.iterations)}),
              flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        f0, f1, fo = (os.path.join(tmp, n) for n in ("p0.pcd", "p1.pcd", "o.pcd"))
        jio.save(f0, jc(planar[0]))
        jio.save(f1, jc(planar[1]))
        icp2d.main([f1, f0, fo])
    print(json.dumps({"part": "i truth", "pair 1": [float(v) for v in cs.planar_truth(1)]}),
          flush=True)


def port_local_run(out):
    """:func:`local_run`'s (f), (g) and (i) with the port on the CPU."""
    from pcl_tpu_torch import filters
    from pcl_tpu_torch.core.cloud import make_cloud
    from pcl_tpu_torch.registration import icp_nl, joint_icp, ndt_2d, trajectory

    torch.cuda.synchronize = lambda: None

    def tc(xyz):
        return make_cloud(xyz, device="cpu")

    z = np.load(os.path.join(out, "street.npz"))
    P = z["P"]
    start = P.copy()
    start[:3, 3] += [0.2, 0.0, 0.2]
    a = 0.02
    start[:3, :3] = start[:3, :3] @ np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                                              [-math.sin(a), 0, math.cos(a)]])
    t0 = time.perf_counter()
    r = icp_nl(tc(z["xyz1"]), tc(z["xyz0"]), torch.tensor(start, dtype=torch.float32),
               warp="rigid_6d", **cs.E_ICP_KW)
    print(json.dumps({"part": "f icp_nl", "s": round(time.perf_counter() - t0, 1),
                      "start": residual(start, P), "left": residual(r.transform.numpy(), P),
                      "iterations": int(r.iterations), "code": int(r.convergence_state)}),
          flush=True)
    scene = cs.make_street(cs.ALLEY_SEED, alleys=True)
    prng = np.random.default_rng(cs.H_PLANAR_SEED)
    planar = [cs.planar_scan(scene, i, prng) for i in range(cs.H_PLANAR_SCANS)]
    for i in range(1, cs.H_PLANAR_SCANS):
        t0 = time.perf_counter()
        r = ndt_2d(tc(planar[i]), tc(planar[i - 1]), **cs.H_NDT2D_KW)
        d = np.abs(r.params.double().numpy() - cs.planar_truth(i))
        print(json.dumps({"part": f"i ndt_2d {i}", "points": len(planar[i]),
                          "s": round(time.perf_counter() - t0, 1),
                          "left_m": float(math.hypot(d[0], d[1])), "left_rad": float(d[2]),
                          "converged": bool(r.converged), "iterations": int(r.iterations)}),
              flush=True)
    scans, golden = trajectory.make_virtual_scan_sequence(
        cs.make_street(), cs.N_SCANS, np.random.default_rng(0), **cs.SEQUENCE_KW)
    vox = [filters.voxel_downsample(tc(s), cs.LEAF) for s in scans[:2]]
    halves = [(vox[1].with_mask(f(vox[1].xyz[:, 0])), vox[0].with_mask(f(vox[0].xyz[:, 0])))
              for f in (lambda x: x < 0, lambda x: x >= 0)]
    t0 = time.perf_counter()
    r = joint_icp([h[0] for h in halves], [h[1] for h in halves], **cs.H_JOINT_KW)
    step = np.linalg.inv(golden[0]) @ golden[1]
    gap = cs.pose_gap(r.transform, torch.from_numpy(step))
    print(json.dumps({"part": "g joint_icp", "s": round(time.perf_counter() - t0, 1),
                      "left_m": gap[0], "left_rad": gap[1], "iterations": int(r.iterations),
                      "code": int(r.convergence_state)}), flush=True)


if __name__ == "__main__":
    what, out = sys.argv[1], sys.argv[2]
    pairs = sys.argv[3].split(",") if len(sys.argv) > 3 else PAIRS
    settings = json.loads(sys.argv[4]) if len(sys.argv) > 4 else None
    {"fronts": lambda: fronts(out), "jax": lambda: jax_run(out, pairs, settings),
     "port": lambda: port_run(out, pairs, settings), "local": lambda: local_run(out),
     "port_local": lambda: port_local_run(out)}[what]()
