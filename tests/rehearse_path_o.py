"""CPU rehearsal of ``chip_smoke.py`` path O (phase 17) at full width, to set
path O's limits before it runs on the card.

    python tests/rehearse_path_o.py jax OUT_DIR    # the JAX package's chain
    python tests/rehearse_path_o.py port OUT_DIR   # the port's chain on the CPU

``jax`` renders path O's inputs (``chip_smoke.path_o_inputs``) and runs the
JAX package's (a)-(e) on them, step for step as ``chip_smoke.path_o_chain``
runs the port's, with its own keys (the port draws from ``torch.Generator``s,
ROADMAP C17), then prints ``chip_smoke.path_o_metrics`` and each function's
seconds as JSON lines. ``port`` runs the port's chain on the CPU. Not a test:
pytest does not collect it. ``tests/test_torch_path_o.py`` runs both chains
at 80 x 60, the port on the JAX package's draws (``jax_chain`` returns them).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def jax_step_draws(key, P, ref_mask, n_ref):
    """The draws a JAX tracker step makes from ``key`` (its split, normal,
    categorical and uniform calls), as the port's ``StepDraws``."""
    import jax
    import jax.numpy as jnp
    import torch

    from pcl_tpu_torch.tracking.particle_filter import StepDraws

    k_noise, k_res, k_sub, _ = jax.random.split(key, 4)
    noise = jax.random.normal(k_noise, (P, 6))
    probs = jnp.asarray(ref_mask, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    sub = jax.random.categorical(k_sub, jnp.log(probs + 1e-30)[None, :].repeat(n_ref, 0))
    u0 = jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / P)
    return StepDraws(*(torch.from_numpy(np.array(x)) for x in (noise, sub, u0)))


def pow2(n: int) -> int:
    """The capacity the JAX side pads path O's detector and tracker clouds
    to: the next power of two of ``n``, so that frames share shapes (the JAX
    package compiles a function once a shape; masked rows change no result).
    The port takes the clouds unpadded."""
    return 1 << max(int(n) - 1, 1).bit_length()


def jax_ground_draws(key, mask):
    """RANSAC's plane samples for ``key`` over ``mask`` (``sac_segmentation``'s
    1,024 hypotheses, valid rows first), as the port's ``(idx, sub)`` for the
    cloud of the valid rows alone."""
    import importlib

    import jax
    import jax.numpy as jnp
    import torch

    jransac = importlib.import_module("pcl_tpu.sac.ransac")
    w = jnp.asarray(mask).astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    k_idx, _ = jax.random.split(key)
    idx = jransac._sample_indices(k_idx, 1024, 3, len(mask), probs)
    return torch.from_numpy(np.array(idx)), torch.zeros(int(np.sum(mask)), dtype=torch.bool)


def _compact(jcloud, keys=()):
    """A JAX cloud's valid rows: ``(xyz, {key: attr})`` as host arrays."""
    m = np.asarray(jcloud.mask)
    return np.asarray(jcloud.xyz)[m], {k: np.asarray(jcloud.attrs[k])[m] for k in keys}


def jax_chain(inp, O, progress=False):
    """Path O's (a)-(e) on the JAX package, as ``path_o_chain`` runs them on
    the port: ``(out, seconds, draws)``, ``draws`` the JAX package's own for
    the port's cores (the ground's RANSAC samples, each tracker step's).
    ``progress`` prints each tracking frame's start on stderr."""
    import jax
    import jax.numpy as jnp

    from pcl_tpu import filters as jfilters
    from pcl_tpu import io as jio
    from pcl_tpu import ml as jml
    from pcl_tpu import sac as jsac
    from pcl_tpu.core.cloud import make_cloud
    from pcl_tpu.keypoints import corners2d as jc2d
    from pcl_tpu.people import classifier as jcls
    from pcl_tpu.people import detector as jdet
    from pcl_tpu.people import hog as jhog
    from pcl_tpu.segmentation import sac_segmentation
    from pcl_tpu.tools import crf_segmentation as jcli
    from pcl_tpu.tracking import kld as jkld
    from pcl_tpu.tracking import klt as jklt
    from pcl_tpu.tracking import particle_filter as jpf

    out, secs, draws = {}, {}, {"kld": [], "pf": []}

    def run(name, fn):
        t0 = time.perf_counter()
        r = fn()
        jax.block_until_ready(r) if isinstance(r, jax.Array) else None
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return r

    frames = inp["frames"]
    intr = inp["intr"]
    K = np.array([[intr.fx, 0, intr.cx], [0, intr.fy, intr.cy], [0, 0, 1.0]])

    def cloud(fr, onehot=False):
        ok = fr["valid"].reshape(-1)
        attrs = {"rgb": jnp.asarray(fr["rgb"].reshape(-1, 3)[ok])}
        if onehot:
            attrs["onehot"] = jnp.asarray(np.eye(len(cs.O_CLASSES), dtype=np.float32)[
                fr["cls"].reshape(-1)[ok]])
        return make_cloud(jnp.asarray(fr["xyz"].reshape(-1, 3)[ok]), attrs=attrs)

    # (a)
    wins = np.concatenate([inp["pos"], inp["neg"]])
    x = run("(a) dollar_hog", lambda: np.stack([jcls.dollar_hog(w) for w in wins]))
    y = np.concatenate([np.ones(len(inp["pos"])), -np.ones(len(inp["neg"]))]).astype(np.float32)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    lin = run("(a) svm_train (linear)", lambda: jml.svm_train(xj, yj, kernel="linear",
                                                              **O["svm"]))
    rbf = run("(a) svm_train_dual (rbf)", lambda: jml.svm_train_dual(
        xj, yj, kernel="rbf", gamma=O["rbf_gamma"], C=O["svm"]["C"]))
    kw = dict(n_folds=O["folds"], seed=0, train_fn=jml.svm_train, classify_fn=jml.svm_classify,
              kernel="linear", **O["svm"])
    _, platt = run("(a) svm_train_probability", lambda: jml.svm_train_probability(x, y, **kw))
    cv = run("(a) svm_cross_validation", lambda: jml.svm_cross_validation(x, y, **kw))
    out["svm"] = dict(cv=cv, platt=tuple(platt),
                      lin_train=float(np.mean(np.sign(np.asarray(jml.svm_classify(lin, xj)))
                                              == y)),
                      rbf_train=float(np.mean(np.sign(np.asarray(jml.svm_classify_dual(rbf, xj)))
                                              == y)),
                      lin_w=np.asarray(lin.w))
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"m{i}.model") for i in range(3)]
        jml.save_libsvm_model(paths[0], lin, platt)
        first = jml.load_libsvm_model(paths[0])
        jml.save_libsvm_model(paths[1], first, jml.load_libsvm_probability(paths[0]))
        second = jml.load_libsvm_model(paths[1])
        jml.save_libsvm_model(paths[2], second, jml.load_libsvm_probability(paths[1]))
        same_file = open(paths[1], "rb").read() == open(paths[2], "rb").read()
        same_arrays = all(np.array_equal(np.asarray(getattr(first, k)),
                                         np.asarray(getattr(second, k)))
                          for k in ("w", "b", "support", "gamma", "mean", "scale"))
        out["files"] = (same_file, same_arrays,
                        tuple(jml.load_libsvm_probability(paths[2])) == tuple(platt))
    w_eff = np.asarray(lin.w * lin.scale).astype(np.float32)
    clf = jcls.PersonClassifier({"window_height": 128, "window_width": 64,
                                 "b": float(np.dot(w_eff.astype(np.float64), np.asarray(lin.mean))
                                            - float(lin.b)), "weights": w_eff})
    # (b)
    det = jdet.GroundBasedPeopleDetector(intrinsics=K, classifier=clf, **O["det"])
    dets, hogs, coeffs = [], [], None
    key = jax.random.PRNGKey(cs.O_SEED)
    for f, fr in enumerate(frames):
        vx, _ = run("(b) voxel grid 0.06 m", lambda: _compact(
            jfilters.voxel_downsample(cloud(fr), O["det_leaf"])))
        vox = make_cloud(jnp.asarray(vx), capacity=pow2(len(vx)))
        if f == 0:
            draws["ground"] = jax_ground_draws(key, np.asarray(vox.mask))
            res = run("(b) RANSAC ground", lambda: sac_segmentation(
                vox, jsac.PlaneModel(), 0.05, key=key))
            c = np.asarray(res.coefficients, np.float64)
            c = c / max(np.linalg.norm(c[:3]), 1e-12)
            off = vx[~np.asarray(res.inliers)[:len(vx)]]
            # turned as the detector turns it: the points off the plane at positive height
            coeffs = -c if len(off) and np.median(off @ c[:3] + c[3]) < 0 else c
            found = run("(b) detect", lambda: det.detect(vox, key=key, rgb_image=fr["rgb"]))
            det.ground_coeffs = coeffs
        else:
            found = run("(b) detect", lambda: det.detect(vox, rgb_image=fr["rgb"]))
        dets.append(found)
        hogs.append(run("(b) hog_features", lambda: [np.asarray(jhog.hog_features(jnp.asarray(
            cs.o_hog_window(fr["grey"], c_, coeffs[:3], coeffs[3], K)))) for c_ in found]))
    out["dets"] = [[(np.asarray(c_.centroid), c_.height, c_.n_points, c_.score) for c_ in d]
                   for d in dets]
    out["ground"], out["hogs"] = coeffs, hogs
    # (c)
    cx, at = run("(c) voxel grid 2 cm", lambda: _compact(
        jfilters.voxel_downsample(cloud(frames[0], True), O["crf_leaf"]), ("rgb", "onehot")))
    crgb = at["rgb"]
    truth = np.argmax(at["onehot"], 1).astype(np.int32)
    rng = np.random.default_rng(cs.O_SEED)
    n2, C = len(cx), len(cs.O_CLASSES)
    flip = rng.random(n2) < O["crf"]["flip"]
    noisy = np.where(flip, (truth + rng.integers(1, C, n2)) % C, truth).astype(np.int32)
    cf = O["crf"]
    p_other = (1.0 - cf["confidence"]) / (C - 1)
    unary = np.full((n2, C), -np.log(p_other), np.float32)
    unary[np.arange(n2), noisy] = -np.log(cf["confidence"])

    def crf(impl):
        m = jml.DenseCRF(n2, C)
        m.set_unary_energy(unary)
        m.add_pairwise_gaussian(cx, cf["sxyz"])
        m.add_pairwise_bilateral(cx, crgb, cf["sxyz"] * 4, cf["srgb"],
                                 n_bins=cf["bilateral_bins"])
        return m.inference(cf["iterations"], filter_impl=impl)

    out["crf"] = {impl: run(f"(c) DenseCRF ({impl})", lambda impl=impl: crf(impl))
                  for impl in ("permutohedral", "grid")}
    out["crf_truth"], out["crf_noisy"], out["crf_xyz"] = truth, noisy, cx

    def cli():
        import contextlib
        import io as pyio

        with tempfile.TemporaryDirectory() as d:
            src, dst = os.path.join(d, "in.pcd"), os.path.join(d, "out.pcd")
            jio.save(src, make_cloud(jnp.asarray(cx), attrs={"rgb": jnp.asarray(crgb),
                                                            "label": jnp.asarray(noisy)}))
            with contextlib.redirect_stdout(pyio.StringIO()):
                jcli.main([src, dst, "-iters", str(cf["iterations"]), "-sxyz", str(cf["sxyz"]),
                           "-srgb", str(cf["srgb"]), "-unary-confidence", str(cf["confidence"])])
            c_ = jio.load(dst)
            return np.asarray(c_.attrs["label"])[np.asarray(c_.mask)]

    out["crf_cli"] = run("(c) tools.crf_segmentation", cli)
    # (d)
    truth0 = frames[0]["centroids"][0]
    near = [c_ for c_ in dets[0] if np.linalg.norm(np.asarray(c_.centroid) - truth0) < 0.5]
    c0 = np.asarray(near[0].centroid if near else truth0, np.float64)
    sel = cs.o_reference_keep(cx, c0, coeffs, O["ref_radius"], top=2.4)
    ref_xyz = (cx[sel] - c0).astype(np.float32)
    ref = make_cloud(jnp.asarray(ref_xyz))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = c0
    kc = O["kld"]
    sn = jnp.asarray(O["step_noise"], jnp.float32)
    ks = jkld.init_kld_tracker(kc["max"], kc["init"], init_pose=jnp.asarray(init),
                               key=jax.random.PRNGKey(cs.O_SEED))
    ps = jpf.init_tracker(O["pf"], init_pose=jnp.asarray(init),
                          key=jax.random.PRNGKey(cs.O_SEED + 1))
    ref_mask = np.ones(len(ref_xyz), bool)
    track = {"kld": [], "pf": [], "states": []}
    t_d = time.perf_counter()
    for f, fr in enumerate(frames):
        if f == 0:
            scene_xyz = cx
        else:
            scene_xyz, _ = run("(d) voxel grid 2 cm", lambda: _compact(
                jfilters.voxel_downsample(cloud(fr), O["track_leaf"])))
        scene = make_cloud(jnp.asarray(scene_xyz), capacity=pow2(len(scene_xyz)))
        if progress:
            print(f"(d) frame {f}: {len(scene_xyz)} voxels, {time.perf_counter() - t_d:.0f} s",
                  file=sys.stderr, flush=True)
        track["states"].append((ks, ps, scene_xyz))
        draws["kld"].append(jax_step_draws(ks.key, kc["max"], ref_mask, 192))
        draws["pf"].append(jax_step_draws(ps.key, O["pf"], ref_mask, 256))
        ks, pose_k = run("(d) step_tracker_kld", lambda: jkld.step_tracker_kld(
            ks, ref, scene, step_noise=sn, bin_size=kc["bin_size"], epsilon=kc["epsilon"],
            z_delta=kc["z_delta"]))
        ps, pose_p = run("(d) step_tracker", lambda: jpf.step_tracker(ps, ref, scene,
                                                                      step_noise=sn))
        track["kld"].append((np.asarray(pose_k), int(np.asarray(ks.active).sum())))
        track["pf"].append(np.asarray(pose_p))
    out["track"], out["c0"], out["n_ref"], out["ref_xyz"] = track, c0, int(sel.sum()), ref_xyz
    # (e)
    g0 = frames[0]["grey"]
    ac = O["agast"]
    score = run("(e) agast", lambda: np.asarray(jc2d.agast_score(jnp.asarray(g0),
                                                                 ac["threshold"])))
    kps = run("(e) agast", lambda: jc2d.agast_keypoints(g0, ac["threshold"]))
    kps = kps[np.argsort(-score[kps[:, 0], kps[:, 1]], kind="stable")[:ac["keep"]]]
    out["agast"] = kps
    pts = kps.astype(np.float32)
    steps = []
    for f in range(len(frames) - 1):
        new, ok = run("(e) pyramidal_klt", lambda: jklt.pyramidal_klt(
            frames[f]["grey"], frames[f + 1]["grey"], pts, **O["klt"]))
        steps.append((pts, np.asarray(new), np.asarray(ok)))
        pts = np.asarray(new)[np.asarray(ok)]
    out["klt"] = steps
    out["brisk"] = run("(e) brisk_descriptor", lambda: jc2d.brisk_descriptor(g0, kps))
    out["brisk_kps"] = run("(e) brisk_keypoints", lambda: jc2d.brisk_keypoints(
        g0, ac["threshold"]))
    out["trajkovic"] = run("(e) trajkovic_keypoints", lambda: jc2d.trajkovic_keypoints(g0))
    return out, secs, draws


def main(argv):
    mode, out_dir = argv[1], argv[2]
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    inp = cs.path_o_inputs(cs.O_FULL)
    print(json.dumps({"inputs_s": time.perf_counter() - t0}), flush=True)
    if mode == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        out, secs, _ = jax_chain(inp, cs.O_FULL, progress=True)
    elif mode == "port":
        out, secs = cs.path_o_chain(inp, cs.O_FULL, "cpu")
    else:
        raise SystemExit(f"unknown mode {mode!r}: jax or port")
    m = cs.path_o_metrics(inp, out, cs.O_FULL)
    print(json.dumps({"mode": mode, "metrics": m}, default=float), flush=True)
    print(json.dumps({"mode": mode, "seconds": secs}), flush=True)
    with open(os.path.join(out_dir, f"path_o_{mode}.json"), "w") as f:
        json.dump({"metrics": m, "seconds": secs}, f, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
