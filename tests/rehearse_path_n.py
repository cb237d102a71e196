"""CPU rehearsal of ``chip_smoke.py`` path N (phase 16) at full width, to set
path N's limits before it runs on the card.

    python tests/rehearse_path_n.py port OUT_DIR   # the port's front end on the CPU
    python tests/rehearse_path_n.py jax OUT_DIR    # the JAX package's chain on it
    python tests/rehearse_path_n.py draws OUT_DIR  # its draws, for the card

``port`` runs ``chip_smoke.path_n_front`` on the CPU at ``N_FULL`` and saves
what the JAX side takes from it (the scene's and the models' voxels with
their normals, the SHOT correspondences with their BOARD frames): the front
end's rounding is not what path N holds the JAX package to. ``jax`` runs the
JAX package's (a)-(g) on those inputs, step for step as ``jax_chain`` does,
with its own keys (the port draws from ``torch.Generator``s, ROADMAP C17),
and prints ``chip_smoke.path_n_metrics``. JSON lines; each function's
seconds too. ``draws`` writes the JAX package's draws at full width
(ObjRecRANSAC's ``i1``, ``i2`` and ``mp1`` at ``seed=3``; the SAC refinement's
of every grouping instance) to ``tests/path_n_draws.npz``, which
``chip_smoke.py`` path N feeds the port's cores, so that the card runs the
rehearsal's draws. Not a test: pytest does not collect it.
``tests/test_torch_path_n.py`` runs both chains at 80 x 60, the port on the
JAX package's draws.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

DRAWS = os.path.join(ROOT, "tests", "path_n_draws.npz")


def jax_sac_draws(result, n_hypotheses):
    """The JAX package's ``refine_grouping_sac`` draws for a grouping result
    (``fold_in(PRNGKey(7), i)``, then RANSAC's split and categorical): one
    ``[n_hypotheses, 3]`` array per used instance, None for an unused one."""
    import importlib

    import jax
    import jax.numpy as jnp

    jransac = importlib.import_module("pcl_tpu.sac.ransac")
    out = []
    for j in range(int(result.instances.shape[0])):
        if not bool(result.instances[j]):
            out.append(None)
            continue
        k_idx, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), j))
        w = result.members[j].astype(jnp.float32)
        probs = w / jnp.maximum(jnp.sum(w), 1.0)
        out.append(np.asarray(jransac._sample_indices(k_idx, n_hypotheses, 3, w.shape[0], probs)))
    return out


def jax_draws(front, N):
    """Every draw of the rehearsal that path N's card run takes: the SAC
    refinement's of each grouping (the groupers are deterministic, so their
    instances are the card's) and ObjRecRANSAC's, as ``{name: int16
    array}``."""
    import jax.numpy as jnp

    from pcl_tpu import recognition as jrec

    out = {k: v.astype(np.int32) for k, v in jax_orr_draws(front, N).items()}
    for i in (3, 5):
        cor = front["cor"][i]
        mp, sp = jnp.asarray(cor["model_pts"]), jnp.asarray(cor["scene_pts"])
        ok = jnp.ones(len(cor["model_pts"]), bool)
        res = {"gc": jrec.geometric_consistency_grouping(
                   mp, sp, ok, gc_size=N["cg_size"], min_cluster_size=N["cg_thresh"],
                   max_instances=N["max_instances"]),
               "hough": jrec.hough3d_grouping(
                   mp, sp, ok, jnp.asarray(cor["centroid"]), bin_size=N["hough_bin"],
                   threshold=N["hough_thresh"], max_instances=N["max_instances"],
                   model_rf=jnp.asarray(cor["model_rf"]), scene_rf=jnp.asarray(cor["scene_rf"]),
                   use_interpolation=True)}
        for k, r in res.items():
            for j, d in enumerate(jax_sac_draws(r, N["sac_hypotheses"])):
                if d is not None:
                    out[f"sac {k} {cs.N_OBJECTS[i]} {j}"] = d.astype(np.int16)
    return out


def jax_orr_draws(front, N, seed=3):
    """The JAX package's ``obj_rec_ransac(..., seed=seed)`` draws on the
    front end's scene and box (its own calls, traced as it traces them)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    kw = N["orr"]
    pd, tol, H = kw["pair_dist"], kw.get("dist_tol", 0.05), kw["n_hypotheses"]
    sxyz = jnp.asarray(front["scene"][0])
    smask = jnp.ones(sxyz.shape[0], bool)
    n_m = len(front["models"][3][0])

    @jax.jit
    def draw(key, sxyz, smask):
        k1, k2 = jax.random.split(key)
        i1 = jax.random.categorical(k1, jnp.log(smask.astype(jnp.float32) + 1e-9), shape=(H,))
        d = jnp.linalg.norm(sxyz[None, :, :] - sxyz[i1][:, None, :], axis=-1)
        ok = smask[None, :] & (jnp.abs(d - jnp.float32(pd)) < jnp.float32(tol))
        i2 = jax.random.categorical(k2, jnp.where(ok, 0.0, -1e9), axis=-1)
        mp1 = jax.random.randint(jax.random.split(key, 3)[2], (512,), 0, n_m)
        return i1, i2, mp1

    i1, i2, mp1 = draw(jax.random.PRNGKey(seed), sxyz, smask)
    return dict(i1=np.asarray(i1, np.int32), i2=np.asarray(i2, np.int32),
                mp1=np.asarray(mp1, np.int32), n_scene=np.int32(sxyz.shape[0]),
                n_model=np.int32(n_m))


def _say(**kw):
    print(json.dumps(kw, default=float), flush=True)


def front_arrays(front):
    """The port's front end as host arrays: ``scene``, ``models`` and
    ``cor`` keyed as ``path_n_front``'s."""
    def host(c):
        return c.xyz.cpu().numpy(), c.attrs["normal"].cpu().numpy()
    return dict(scene=host(front["scene"]),
                models={i: host(m) for i, m in front["models"].items()}, cor=front["cor"])


def jax_chain(inp, front, N, full=True, log=None):
    """Path N on the JAX package, on the port's front end ``front``
    (``front_arrays``): ``(out, seconds, draws)``; ``out`` has
    ``path_n_chain``'s keys, ``draws`` the JAX package's draws of each
    random step as torch tensors, keyed as ``path_n_chain`` takes them.
    ``full=False`` leaves out the ESF database (its core has its own parity
    test on the JAX draws). ``log(name, seconds)`` hears of each step."""
    import importlib

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from pcl_tpu import features as jf
    from pcl_tpu import recognition as jrec
    from pcl_tpu.core.cloud import Cloud as JCloud
    from pcl_tpu.recognition import face_detection, ism, linemod, orr, verification

    jransac = importlib.import_module("pcl_tpu.sac.ransac")
    out, secs, draws = {}, {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn())
        secs[name] = time.perf_counter() - t0
        if log is not None:
            log(name, secs[name])
        return r

    def cloud(xyz, normal=None):
        xyz = jnp.asarray(np.asarray(xyz, np.float32))
        attrs = {} if normal is None else {"normal": jnp.asarray(normal)}
        return JCloud(xyz=xyz, mask=jnp.ones(xyz.shape[0], bool), attrs=attrs)

    def tt(x):
        return torch.from_numpy(np.array(x)).long()

    frame, fg = inp["frame"], inp["frame_g"]
    scene = cloud(*front["scene"])
    models = {i: cloud(*m) for i, m in front["models"].items()}
    out["scene_xyz"], out["scene_normal"] = front["scene"]
    out["models"] = front["models"]

    # (a)
    out["groups"] = {}
    for i in (3, 5):
        name = cs.N_OBJECTS[i]
        cor = front["cor"][i]
        mp, sp = jnp.asarray(cor["model_pts"]), jnp.asarray(cor["scene_pts"])
        ok = jnp.ones(len(cor["model_pts"]), bool)
        res = {}
        res["gc"] = run(f"geometric_consistency_grouping ({name})",
                        lambda: jrec.geometric_consistency_grouping(
                            mp, sp, ok, gc_size=N["cg_size"], min_cluster_size=N["cg_thresh"],
                            max_instances=N["max_instances"]))
        res["hough"] = run(f"hough3d_grouping ({name})", lambda: jrec.hough3d_grouping(
            mp, sp, ok, jnp.asarray(cor["centroid"]), bin_size=N["hough_bin"],
            threshold=N["hough_thresh"], max_instances=N["max_instances"],
            model_rf=jnp.asarray(cor["model_rf"]), scene_rf=jnp.asarray(cor["scene_rf"]),
            use_interpolation=True))
        for k in ("gc", "hough"):
            r = res[k]
            res[k + "_sac"] = run(f"refine_grouping_sac ({k}, {name})",
                                  lambda r=r: jrec.refine_grouping_sac(
                                      mp, sp, r, N["sac_threshold"],
                                      n_hypotheses=N["sac_hypotheses"]))
            draws[f"sac {k} {name}"] = [None if d is None else tt(d)
                                        for d in jax_sac_draws(r, N["sac_hypotheses"])]
        out["groups"][i] = dict(cor=cor, **{k: tuple(np.asarray(x) for x in v)
                                            for k, v in res.items()})

    # (c)
    box = models[3]
    kw = dict(N["orr"])
    pd, tol, H = kw["pair_dist"], kw.get("dist_tol", 0.05), kw["n_hypotheses"]
    T, sup = run("obj_rec_ransac (box)", lambda: orr.obj_rec_ransac(box, scene, seed=3, **kw))
    out["orr"] = (np.asarray(T), float(sup))

    if not full:
        draws["orr"] = [torch.from_numpy(v).long() for k, v in jax_orr_draws(
            front, N).items() if k in ("i1", "i2", "mp1")]
    hist, n_valid = run("pair_feature_hash_table (box)", lambda: orr.pair_feature_hash_table(
        box, pd, N["hash_pairs"], tol, N["hash_bins"], seed=4))
    out["hash"] = (hist, n_valid)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    i1 = jax.random.categorical(k1, jnp.log(box.mask.astype(jnp.float32) + 1e-9),
                                shape=(N["hash_pairs"],))
    d = jnp.linalg.norm(box.xyz[None, :, :] - box.xyz[i1][:, None, :], axis=-1)
    okk = box.mask[None, :] & (jnp.abs(d - pd) < tol)
    draws["hash"] = [tt(i1), tt(jax.random.categorical(k2, jnp.where(okk, 0.0, -1e9), axis=-1))]

    # (b): the port's hypotheses are built the same way (host numpy)
    sub = cs.hv_subsample(np.asarray(box.xyz), N)
    hyps, names = [], []
    for k in ("gc_sac", "hough_sac"):
        inst, _, Ts = out["groups"][3][k]
        for j in np.nonzero(inst)[0]:
            r = run(f"trimmed_icp ({k} {j})", lambda T=Ts[j]: orr.trimmed_icp(
                box, scene, init=jnp.asarray(T), **N["tricp"]))
            hyps.append(np.asarray(r.transform))
            names.append(f"{k} {j}")
    hyps.append(out["orr"][0])
    names.append("orr")
    for name, W in cs.wrong_hypotheses(inp, N):
        hyps.append(W)
        names.append(name)
    Ts = jnp.asarray(np.stack(hyps).astype(np.float32))
    ok = jnp.ones(len(hyps), bool)
    out["hyp_T"], out["hyp_names"] = np.stack(hyps), names
    out["hv"] = {}
    for vname, fn, kw in (("greedy", verification.greedy_hypothesis_verification, N["hv"]),
                          ("global", verification.global_hypothesis_verification,
                           dict(N["hv"], **N["hv_global"])),
                          ("papazov", verification.papazov_hypothesis_verification, N["hv"])):
        out["hv"][vname] = np.asarray(run(f"{vname} verification", lambda fn=fn, kw=kw: fn(
            jnp.asarray(sub), Ts, ok, scene.xyz, scene.mask, **kw)))

    # (d)
    region = cs._bbox(frame["part"] == 3)
    q0 = run("build_modality_maps (frame 0)", lambda: linemod.build_modality_maps(
        frame["rgb"] * 255.0, frame["xyz"], frame["valid"]))
    tmpl = linemod.extract_template([np.asarray(q) for q in q0], region,
                                    n_features=N["lm_features"])
    out["lm_template"] = tmpl
    out["lm"] = run("line_rgbd_detect (frame g)", lambda: linemod.line_rgbd_detect(
        fg["rgb"] * 255.0, fg["xyz"], fg["valid"], [tmpl], threshold=N["lm_threshold"]))
    bm = jnp.asarray(frame["part"] == 3)
    out["dmap"] = np.asarray(run("distance_map (box mask)", lambda: orr.distance_map(bm)))
    out["eroded"] = np.asarray(run("mask_erode (box mask)", lambda: orr.mask_erode(bm)))

    # (e)
    db = run("train_global_database (VFH)", lambda: jrec.train_global_database(
        inp["surfaces"], "vfh", n_views=N["gp_views"]))
    clusters = run("segment_scene_clusters", lambda: jrec.segment_scene_clusters(
        scene, **N["seg"]))
    out["gp_clusters"] = clusters
    k_idx, _ = jax.random.split(jax.random.PRNGKey(0))
    w = scene.mask.astype(jnp.float32)
    draws["plane"] = tt(jransac._sample_indices(k_idx, 1024, 3, w.shape[0],
                                                w / jnp.maximum(jnp.sum(w), 1.0)))
    out["gp_vfh"] = run("recognize_clusters (VFH)", lambda: jrec.recognize_clusters(
        db, clusters, **N["gp_recognize"]))
    out["gp_db_views"] = db.views
    if full:
        edb = run("train_global_database (ESF)", lambda: jrec.train_global_database(
            inp["surfaces"], "esf", n_views=N["gp_views"]))
        out["gp_esf"] = run("recognize_clusters (ESF)", lambda: jrec.recognize_clusters(
            edb, clusters, **N["gp_recognize"]))
        out["gp_esf_views"] = edb.views

    # (f)
    def fpfh(pts, nrm):
        c = cloud(pts, nrm)
        return np.asarray(jf.estimate_fpfh(c, k=min(N["fpfh_k"], len(pts) - 1)))

    mlist = [front["models"][i] for i in cs.N_OBJECTS]
    model = run("train_ism", lambda: ism.train_ism(
        [m[0] for m in mlist], [m[1] for m in mlist], [0, 1, 2], fpfh,
        sampling_size=N["ism_sampling"], n_clusters=N["ism_clusters"]))
    out["ism_model"] = model

    @jax.jit
    def km_draw(key):
        w = jnp.ones(model.n_visual_words, jnp.float32)
        probs = w / jnp.maximum(jnp.sum(w), 1.0)
        return jax.random.categorical(
            key, jnp.log(probs + 1e-30)[None, :].repeat(model.n_clusters, 0))

    draws["ism"] = [tt(km_draw(jax.random.PRNGKey(a))) for a in range(5)]
    votes = run("find_objects (box)", lambda: ism.find_objects(
        model, out["scene_xyz"], out["scene_normal"], 0, fpfh, sampling_size=N["ism_sampling"]))
    sigma = float(model.sigmas[0])
    out["ism_peaks"] = run("find_strongest_peaks", lambda: ism.find_strongest_peaks(
        votes[0], votes[1], 0, 10.0 * sigma, sigma))
    out["ism_votes"] = len(votes[0])

    # (g)
    pos, neg = cs.face_patches(frame, N, np.random.default_rng(13))
    det = run("train_face_detector", lambda: face_detection.train_face_detector(
        pos, neg, patch=N["face"]["patch"]))
    out["faces"] = run("detect_faces (frame g)", lambda: face_detection.detect_faces(
        det, fg["depth"], stride=N["face"]["stride"], threshold=N["face"]["threshold"]))
    return out, secs, draws


def main(argv):
    step, outdir = argv[1], argv[2]
    os.makedirs(outdir, exist_ok=True)
    import pickle

    import torch

    N = cs.N_FULL
    inp = cs.path_n_inputs(N)
    path = os.path.join(outdir, "path_n_front.pkl")
    if step == "port":
        secs = {}

        def run(name, fn):
            t0 = time.perf_counter()
            r = fn()
            secs[name] = time.perf_counter() - t0
            _say(step=name, s=secs[name])
            return r

        front = cs.path_n_front(inp, N, torch.device("cpu"), run)
        with open(path, "wb") as f:
            pickle.dump(front_arrays(front), f)
        _say(voxels=len(front["scene"].xyz),
             models={cs.N_OBJECTS[i]: len(m.xyz) for i, m in front["models"].items()},
             correspondences={cs.N_OBJECTS[i]: len(c["model_pts"])
                              for i, c in front["cor"].items()})
    elif step == "jax":
        with open(path, "rb") as f:
            front = pickle.load(f)
        out, secs, _ = jax_chain(inp, front, N, log=lambda k, v: _say(step=k, s=v))
        _say(metrics=cs.path_n_metrics(inp, out, N))
    elif step == "draws":
        with open(path, "rb") as f:
            front = pickle.load(f)
        np.savez_compressed(DRAWS, **jax_draws(front, N))
        _say(saved=DRAWS)
    else:
        raise SystemExit(f"unknown step {step!r}")


if __name__ == "__main__":
    main(sys.argv)
