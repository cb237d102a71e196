"""CPU rehearsal of ``chip_smoke.py`` path K (phase 13) at full width: path
E's pair with path K's intensity and RGB, to set path K's settings and
limits before it runs on the card.

    python tests/rehearse_path_k.py fronts OUT_DIR   # the port's front end, saved
    python tests/rehearse_path_k.py jax OUT_DIR      # the JAX package's (c) and (d)
    python tests/rehearse_path_k.py port OUT_DIR     # the port's (a)-(e), CPU

``fronts`` runs path E's front end (ground RANSAC, 0.3 m voxels, normals,
FPFH) with the port on the CPU and saves the voxels with their attributes.
``jax`` takes them to the JAX package: Harris 3-D and ISS keypoints, SHOT at
every voxel, the share of keypoint matches within two voxels of the true
counterpart (SHOT and FPFH), prerejective RANSAC with path E's settings but
a quarter of its hypotheses (8,192; env ``K_REHEARSAL_HYPOTHESES``) on the
SHOT matches refined by point-to-plane ICP, and Euclidean clusters.
``port`` runs the same on the port (without the prerejective sweep, whose
plain 1-NN on the CPU would take hours), SHOT, USC and RoPS of scan 1 moved
as in (e) (rows beyond each tolerance, on every row and on the rows
``chip_smoke.invariance_firm`` finds firm, the rows (e) holds to
``K_INVARIANCE_SHARE``), and prints the times. JSON lines. Not a test: pytest does not
collect it. It needs both packages and takes tens of minutes.
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


def _say(**kw):
    print(json.dumps(kw), flush=True)


def fronts(out):
    from pcl_tpu_torch.core import cloud as cloud_mod

    torch.cuda.synchronize = lambda: None
    cloud_mod._device = lambda device=None: torch.device("cpu")
    os.makedirs(out, exist_ok=True)
    raw, P = cs.path_k_scans(cs.make_street())
    arrays = {"P": P}
    k = None
    for i, c in enumerate(raw):
        nc, f, _, k, _ = cs.global_front(c, k=k)
        for name, v in (("xyz", nc.xyz), ("fpfh", f), *nc.attrs.items()):
            arrays[f"{name}{i}"] = v.numpy()
        for name, v in (("rawxyz", c.xyz), *((f"raw{a}", t) for a, t in c.attrs.items())):
            arrays[f"{name}{i}"] = v.numpy()
    np.savez(os.path.join(out, "path_k.npz"), **arrays)
    _say(part="fronts", voxels=[len(arrays["xyz0"]), len(arrays["xyz1"])], fpfh_k=k)


def residual(T, P):
    """Across the street and up (m), along it (m), rotation (rad)."""
    T = np.asarray(T, np.float64)
    d = T[:3, 3] - P[:3, 3]
    R = T[:3, :3] @ P[:3, :3].T
    ang = math.acos(max(-1.0, min(1.0, 0.5 * (np.trace(R) - 1))))
    return round(math.hypot(d[0], d[1]), 6), round(abs(d[2]), 6), round(ang, 6)


def _share(f1, f0, x1, x0, k1, k0, P):
    """The share of keypoint matches within K_MATCH of the true counterpart
    (the nearest descriptor, float64 on the host)."""
    a, b = f1[k1].astype(np.float64), f0[k0].astype(np.float64)
    d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    nn = np.argmin(d, axis=1)
    truth = x1[k1] @ P[:3, :3].T + P[:3, 3]
    return float(np.mean(np.linalg.norm(truth - x0[k0][nn], axis=1) <= cs.K_MATCH))


def jax_run(out):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import importlib

    from pcl_tpu.core.cloud import Cloud
    from pcl_tpu.features import shot
    from pcl_tpu.keypoints.harris import harris3d_keypoints
    from pcl_tpu.keypoints.iss import iss3d_keypoints
    from pcl_tpu.registration import ia
    from pcl_tpu.segmentation import clustering
    jicp = importlib.import_module("pcl_tpu.registration.icp")

    z = np.load(os.path.join(out, "path_k.npz"))
    P = z["P"]
    clouds, kidx, shots = [], [], []
    for i in (0, 1):
        c = Cloud(xyz=jnp.asarray(z[f"xyz{i}"]), mask=jnp.ones(len(z[f"xyz{i}"]), bool),
                  attrs={"normal": jnp.asarray(z[f"normal{i}"]),
                         "curvature": jnp.asarray(z[f"curvature{i}"])})
        t0 = time.perf_counter()
        h = np.asarray(harris3d_keypoints(c, cs.K_RADIUS, threshold=cs.K_HARRIS_THRESHOLD)[0])
        s = np.asarray(iss3d_keypoints(c, cs.H_SALIENT, 0.5 * cs.H_SALIENT,
                                       density_weights=True)[0])
        f = np.asarray(shot.estimate_shot_interpolated(c, cs.K_RADIUS, k=cs.K_SHOT_K))
        labels, n = clustering.euclidean_clusters(c, cs.K_CLUSTER_TOLERANCE,
                                                  min_cluster_size=cs.K_CLUSTER_MIN)
        sizes = np.bincount(np.asarray(labels)[np.asarray(labels) >= 0])
        _say(part="jax keypoints, SHOT, clusters", scan=i, harris=int(h.sum()),
             iss=int(s.sum()), components=int(n), clusters=len(sizes),
             sizes=sorted(sizes.tolist(), reverse=True)[:15],
             s=round(time.perf_counter() - t0, 1))
        clouds.append(c)
        kidx.append(np.nonzero(h | s)[0])
        shots.append(f)
    x0, x1 = z["xyz0"], z["xyz1"]
    _say(part="jax inlier share", shot=_share(shots[1], shots[0], x1, x0, kidx[1], kidx[0], P),
         fpfh=_share(z["fpfh1"], z["fpfh0"], x1, x0, kidx[1], kidx[0], P))
    tgt, src = clouds
    km = [np.zeros(len(z[f"xyz{i}"]), bool) for i in (0, 1)]
    for i in (0, 1):
        km[i][kidx[i]] = True
    skp = Cloud(xyz=src.xyz, mask=jnp.asarray(km[1]))
    tkp = Cloud(xyz=tgt.xyz, mask=jnp.asarray(km[0]))
    # path E's 32,768 hypotheses take ~30 GB on the XLA CPU path: a quarter
    # of them unless the environment asks for more
    kw = dict(cs.E_PRE_KW, n_hypotheses=int(os.environ.get("K_REHEARSAL_HYPOTHESES", 8192)))
    t0 = time.perf_counter()
    res = ia.prerejective_ransac(skp, jnp.asarray(shots[1]), tkp, jnp.asarray(shots[0]), **kw)
    T = np.asarray(res.transform)
    secs = time.perf_counter() - t0
    ref = jicp.icp(src, tgt, init_transform=jnp.asarray(T, jnp.float32),
                   variant="point_to_plane", **cs.E_ICP_KW)
    _say(part="jax prerejective on SHOT", hypotheses=kw["n_hypotheses"], s=round(secs, 1),
         valid=bool(res.valid),
         error=float(res.error), global_=residual(T, P),
         p2plane=residual(np.asarray(ref.transform), P))


def port_run(out):
    from pcl_tpu_torch import features, keypoints, segmentation
    from pcl_tpu_torch.core.cloud import Cloud
    from pcl_tpu_torch.core.transforms import transform_points
    from pcl_tpu_torch.features import rops, shape_context

    z = np.load(os.path.join(out, "path_k.npz"))
    P = z["P"]
    clouds, kidx, shots = [], [], []
    for i in (0, 1):
        attrs = {a: torch.from_numpy(z[f"{a}{i}"]) for a in ("normal", "curvature", "intensity",
                                                              "rgb")}
        c = Cloud(xyz=torch.from_numpy(z[f"xyz{i}"]), mask=torch.ones(len(z[f"xyz{i}"]),
                                                                      dtype=torch.bool),
                  attrs=attrs)
        t0 = time.perf_counter()
        h = keypoints.harris3d_keypoints(c, cs.K_RADIUS, threshold=cs.K_HARRIS_THRESHOLD)[0]
        su = keypoints.susan_keypoints(c, cs.K_RADIUS)[0]
        s = keypoints.iss3d_keypoints(c, cs.H_SALIENT, 0.5 * cs.H_SALIENT,
                                      density_weights=True)[0]
        t1 = time.perf_counter()
        f = features.estimate_shot(c, cs.K_RADIUS, k=cs.K_SHOT_K)
        t2 = time.perf_counter()
        labels, n = segmentation.euclidean_clusters(c, cs.K_CLUSTER_TOLERANCE,
                                                    min_cluster_size=cs.K_CLUSTER_MIN)
        lab = labels.numpy()
        sizes = np.bincount(lab[lab >= 0])
        _say(part="port keypoints, SHOT, clusters", scan=i, harris=int(h.sum()),
             susan=int(su.sum()), iss=int(s.sum()), components=int(n), clusters=len(sizes),
             sizes=sorted(sizes.tolist(), reverse=True)[:15], keypoints_s=round(t1 - t0, 1),
             shot_s=round(t2 - t1, 1))
        clouds.append(c)
        kidx.append(torch.nonzero(h | s)[:, 0].numpy())
        shots.append(f.numpy())
    x0, x1 = z["xyz0"], z["xyz1"]
    _say(part="port inlier share", shot=_share(shots[1], shots[0], x1, x0, kidx[1], kidx[0], P),
         fpfh=_share(z["fpfh1"], z["fpfh0"], x1, x0, kidx[1], kidx[0], P))
    # (e): scan 1 moved as phase 13 moves it
    src = clouds[1]
    rng = np.random.default_rng(cs.E_SEED + 13)
    M = np.eye(4)
    M[:3, :3] = cs.axis_rotation(rng.normal(size=3), math.radians(cs.K_MOVE[1]))
    M[:3, 3] = rng.normal(size=3) * cs.K_MOVE[0] / math.sqrt(3.0)
    Mt = torch.from_numpy(M).float()
    moved = Cloud(xyz=transform_points(Mt, src.xyz), mask=src.mask,
                  attrs=dict(src.attrs, normal=src.attrs["normal"] @ Mt[:3, :3].T))
    for name, fn in (("SHOT", lambda c: features.estimate_shot(c, cs.K_RADIUS, k=cs.K_SHOT_K)),
                     ("USC", lambda c: shape_context.estimate_usc(c, cs.K_RADIUS)[0]),
                     ("RoPS", lambda c: rops.estimate_rops(c, cs.K_RADIUS)[0])):
        a = torch.from_numpy(shots[1]) if name == "SHOT" else fn(src)
        b = fn(moved)
        d = (a - b).abs().reshape(a.shape[0], -1).amax(1).numpy()
        firm = cs.invariance_firm(src, name)
        off = int((d[firm] > cs.K_INVARIANCE_TOL).sum())
        _say(part="port invariance", what=name, rows=len(d),
             beyond={str(t): int((d > t).sum()) for t in (1e-5, 1e-4, 1e-3, 1e-2)},
             max=float(d.max()), firm=int(firm.sum()), firm_beyond_tol=off,
             firm_share_beyond_tol=off / max(int(firm.sum()), 1))


if __name__ == "__main__":
    what, out = sys.argv[1], sys.argv[2]
    {"fronts": fronts, "jax": jax_run, "port": port_run}[what](out)
