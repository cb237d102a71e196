"""CPU rehearsal of ``chip_smoke.py`` path L (phase 14) at full width, both
packages, to set path L's limits before it runs on the card.

    python tests/rehearse_path_l.py port OUT_DIR   # the port's chain on the CPU
    python tests/rehearse_path_l.py jax OUT_DIR    # the JAX package's, on the port's inputs

``port`` runs ``chip_smoke.path_l_chain`` on the CPU at ``L_FULL`` and saves
what the JAX side takes from it (the frame's k-NN normals, the voxels with
their normals and colours, the back wall's points, the seeds and the voxels'
(b) clusters: the front end's rounding is not what path L holds the JAX
package to). ``jax`` runs the JAX package's functions on those inputs,
step for step as ``jax_chain`` does, and prints the same measures
(``chip_smoke.path_l_metrics``). JSON lines; each function's seconds too.
Not a test: pytest does not collect it. The port step takes ~15 min on 8
cores, the JAX step ~30 min. ``tests/test_torch_path_l.py`` runs both chains
at 80 x 60.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

INPUTS = ("frame_normal", "vox_xyz", "vox_normal", "vox_rgb", "wall_xyz", "walker_seeds",
          "vox_cluster")


def _say(**kw):
    print(json.dumps(kw, default=float), flush=True)


def jax_chain(frame, inp, L, full=True):
    """Path L on the JAX package, on the port's front end ``inp`` (the keys
    of ``INPUTS``): ``(out, seconds)`` with ``path_l_chain``'s keys.
    ``full=False`` leaves out what the CPU test does not compare (the
    iterated and trimmed B-splines, MLS upsampling, grid projection, surfel
    smoothing; each has its own parity test)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from pcl_tpu import features as jf
    from pcl_tpu import keypoints as jk
    from pcl_tpu import segmentation as js
    from pcl_tpu import surface as jsrf
    from pcl_tpu.core.cloud import Cloud as JCloud

    out, secs = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn())
        secs[name] = time.perf_counter() - t0
        return r

    def cloud(xyz, mask=None, **attrs):
        xyz = np.asarray(xyz, np.float32)
        m = np.ones(len(xyz), bool) if mask is None else np.asarray(mask)
        return JCloud(xyz=jnp.asarray(np.where(m[:, None], xyz, 0).astype(np.float32)),
                      mask=jnp.asarray(m), attrs={k: jnp.asarray(v) for k, v in attrs.items()})

    H, W = L["shape"]
    pose = frame["pose"]
    xyz, valid = frame["xyz"], frame["valid"]
    pix = cloud(xyz.reshape(-1, 3), valid.reshape(-1), rgb=frame["rgb"].reshape(-1, 3))
    labels, regions = run("organized_multi_plane_segmentation",
                          lambda: js.organized_multi_plane_segmentation(
                              xyz, inp["frame_normal"], valid, **L["planes"]))
    out["plane_labels"], out["regions"] = labels, regions
    i_n, _ = jf.integral_image_normals(jnp.asarray(xyz), jnp.asarray(valid))
    i_n = np.asarray(i_n)
    out["integral_regions"] = js.organized_multi_plane_segmentation(
        xyz, i_n, valid & (np.abs(i_n).sum(-1) > 0), **L["planes"])[1]
    out["cc_labels"] = np.asarray(run("organized_connected_components",
                                      lambda: js.organized_connected_components(
                                          jnp.asarray(xyz), jnp.asarray(valid),
                                          L["cc_distance"])))
    org = JCloud(xyz=jnp.asarray(xyz.reshape(-1, 3)), mask=jnp.asarray(valid.reshape(-1)),
                 width=W, height=H)
    out["fast_mesh"] = run("organized_fast_mesh",
                           lambda: jsrf.organized_fast_mesh(org, L["fast_mesh_edge"]))

    floor = max(cs.same_plane_regions(regions, cs.nearest_region(regions, 0, pose)),
                key=lambda r: r.count)
    coeff = floor.coefficients
    fpts = xyz.reshape(-1, 3)[np.concatenate(
        [r.indices for r in cs.same_plane_regions(regions, floor)])]
    hull, n_concave = run("convex_hull + concave_hull (floor)",
                          lambda: cs.hull_polygon(fpts, coeff, L["hull_inset"],
                                                  L["concave_alpha"], jax_hulls))
    out["hull"], out["concave_edges"], out["floor_coeff"] = hull, n_concave, coeff
    prism = run("extract_polygonal_prism",
                lambda: js.extract_polygonal_prism(pix, hull, coeff, *L["prism"]))
    cl, _ = run("euclidean_clusters", lambda: js.euclidean_clusters(
        cloud(xyz.reshape(-1, 3), valid.reshape(-1) & prism), **L["cluster"]))
    out["prism"], out["clusters"] = prism, np.asarray(cl)

    vxyz = inp["vox_xyz"]
    vpart = np.argmin(cs.room_parts(cs.to_world(vxyz, pose)), 0)
    vox = cloud(vxyz, normal=inp["vox_normal"], rgb=inp["vox_rgb"])
    out["vox_xyz"], out["vox_part"] = vxyz, vpart
    mls = {}
    for r in sorted(set(L["smoothed"]) | {L["mls_radius"]}):
        mls[r] = run(f"moving_least_squares r={r}",
                     lambda r=r: jsrf.moving_least_squares(vox, r, polynomial_order=2))
    out["mls_xyz"] = np.asarray(mls[L["mls_radius"]].xyz)
    out["keypoints"] = run("smoothed_surfaces_keypoints",
                           lambda: jk.smoothed_surfaces_keypoints(
                               vox, [mls[r] for r in L["smoothed"]], L["smoothed"][1]))
    out["gp3"] = run("greedy_projection_triangulation",
                     lambda: jsrf.greedy_projection_triangulation(vox, **L["gp3"]))
    out["hoppe"] = run("reconstruct_hoppe",
                       lambda: jsrf.reconstruct_hoppe(vox, resolution=L["hoppe_res"]))
    out["poisson"] = run("poisson_reconstruction",
                         lambda: jsrf.poisson_reconstruction(vox, depth=L["poisson_depth"]))
    obj = {i: cloud(vxyz[vpart == i], normal=inp["vox_normal"][vpart == i],
                    rgb=inp["vox_rgb"][vpart == i]) for i in cs.L_OBJECTS}
    out["rbf"] = run("marching_cubes_rbf (box)",
                     lambda: jsrf.marching_cubes_rbf(obj[3], resolution=L["rbf_res"]))
    V, F = out["hoppe"]
    out["laplacian"] = run("laplacian_smooth", lambda: jsrf.laplacian_smooth(V, F))
    out["taubin"] = run("taubin_smooth", lambda: jsrf.taubin_smooth(V, F))
    wall = cloud(inp["wall_xyz"])
    residuals = []
    fits = (("fit_bspline_surface", jsrf.fit_bspline_surface),
            ("fit_bspline_surface_iterated", jsrf.fit_bspline_surface_iterated),
            ("fit_trimmed_bspline_surface", jsrf.fit_trimmed_bspline_surface))
    for name, fit in fits if full else fits[:1]:
        s = run(name, lambda fit=fit: fit(wall))
        s = getattr(s, "surface", s)
        uv = np.clip((((inp["wall_xyz"] - np.asarray(s.centroid)) @ np.asarray(s.frame).T)[:, :2]
                      - np.asarray(s.origin)) / np.asarray(s.scale), 0, 1)
        p = np.asarray(jsrf.eval_bspline_surface(s, jnp.asarray(uv, jnp.float32)))
        residuals.append(float(np.linalg.norm(p - inp["wall_xyz"], axis=1).mean()))
    out["bspline_residual"] = residuals
    if full:
        up = L["upsample"]
        run("mls_upsample_local_plane (sphere)", lambda: jsrf.mls_upsample_local_plane(
            obj[4], up["search_radius"], up["upsampling_radius"], up["step_size"]))
        run("grid_projection (sphere)", lambda: jsrf.grid_projection(obj[4],
                                                                    resolution=L["grid_res"]))
        run("surfel_smoothing (cylinder)", lambda: jsrf.surfel_smoothing(obj[5],
                                                                        L["surfel_radius"]))

    sv = run("supervoxel_clustering", lambda: js.supervoxel_clustering(vox, **L["sv"]))
    out["sv_labels"] = np.asarray(sv.labels)
    out["lccp"] = run("lccp_segmentation", lambda: js.lccp_segmentation(sv))[0]
    out["cpc"] = run("cpc_segmentation", lambda: js.cpc_segmentation(vox, sv))
    box_c = cs.to_camera(cs.L_CENTERS[3], pose)
    out["mincut"] = run("min_cut_segmentation (box)", lambda: js.min_cut_segmentation(
        vox, box_c, radius=cs.L_BOX_RADIUS, **L["mincut"]))
    lo, hi = (np.array(b) for b in cs.G_BOX)
    vw = cs.to_world(vxyz, pose)
    grab0 = np.all((vw >= lo - L["grab_margin"]) & (vw <= hi + L["grab_margin"]), axis=1)
    out["grab"] = run("grab_cut (box)", lambda: js.grab_cut(vox, grab0))
    seeds = inp["walker_seeds"]
    out["hue"] = np.asarray(run("seeded_hue_segmentation (box)",
                                lambda: js.seeded_hue_segmentation(
                                    vox, jnp.asarray(seeds == 0), **L["hue"])))
    out["walker"] = np.asarray(run("random_walker", lambda: js.random_walker(
        vox, jnp.asarray(seeds.astype(np.int32)), **L["walker"])))
    fpfh = np.asarray(run("estimate_fpfh (voxels)", lambda: jf.estimate_fpfh(vox,
                                                                          k=L["fpfh_k"])))
    vc = inp["vox_cluster"]
    out["vox_cluster"] = vc
    clf = js.UnaryClassifier()
    run("UnaryClassifier.train", lambda: clf.train([fpfh[vc == c] for c in range(vc.max() + 1)]))
    out["unary"] = run("UnaryClassifier.segment", lambda: clf.segment(fpfh))
    return out, secs


def jax_hulls(flat, alpha):
    """``chip_smoke.hull_polygon``'s hulls with the JAX package's."""
    import jax.numpy as jnp

    from pcl_tpu.core.cloud import Cloud as JCloud
    from pcl_tpu.surface import concave_hull, convex_hull

    jc = JCloud(xyz=jnp.asarray(flat), mask=jnp.ones(len(flat), bool))
    return convex_hull(jc, dim=2)[0], concave_hull(jc, alpha, dim=2)[1]


def main(argv):
    import torch

    step, out_dir = argv[1], argv[2]
    os.makedirs(out_dir, exist_ok=True)
    L = cs.L_FULL
    frame = cs.path_l_frame(L)
    path = os.path.join(out_dir, "path_l_inputs.npz")
    if step == "port":
        t0 = time.perf_counter()
        out, secs = cs.path_l_chain(frame, L, torch.device("cpu"))
        _say(part="port", seconds=time.perf_counter() - t0, secs=secs)
        np.savez(path, **{k: out[k] for k in INPUTS})
    else:
        inp = dict(np.load(path))
        t0 = time.perf_counter()
        out, secs = jax_chain(frame, inp, L)
        _say(part="jax", seconds=time.perf_counter() - t0, secs=secs)
    m = cs.path_l_metrics(frame, out, L)
    _say(part=f"{step} metrics", **m)


if __name__ == "__main__":
    main(sys.argv)
