"""The slice as a whole against the JAX package on the CPU: path M's chain
(``chip_smoke.path_m_chain``) on two quarter-size scans of path C's street
(30,000 points, 720 x 360 range images) and path L's 80 x 60 frame, beside
the same calls of the JAX package on the same inputs; then
``chip_smoke.path_m_checks`` on the port's outputs, as phase 15 runs them
on the card.

- (a)-(f), (h): trees, change masks, the double buffer's leaves, points and
  XOR stream, searches, counts, levels, adjacency, occupancy, rays and
  iterator counts equal; centroids within 1e-6 of the coordinates' scale.
- (g): the approximate 1-NN equal; B1's exact 1-NN against the JAX
  package's ``nn1`` (on the CPU its matmul-identity distance, ROADMAP C1):
  the chosen points' float64 distances within the rounding of the score.
- (i): range images equal but for pixels a point within 1e-4 pixel of an
  edge can reach (C27); ``to_cloud`` within 1e-6 of the range.
- (j): NARF of the JAX package's images run by the port: borders and
  keypoints equal, descriptors within 1e-6.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu import features as jfeat
from pcl_tpu import octree as joc
from pcl_tpu.core import range_image as jri
from pcl_tpu.core.cloud import make_cloud as jmake_cloud
from pcl_tpu.octree import iterators as jit_
from pcl_tpu.octree.double_buffer import DoubleBufferedOctree as JDouble
from pcl_tpu.search import bruteforce as jbf

from pcl_tpu_torch import features as tfeat
from pcl_tpu_torch import interop
from pcl_tpu_torch.registration import trajectory

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
cs = importlib.import_module("chip_smoke")

SCAN_POINTS = cs.SCAN_CAPACITY // 4


def jax_chain(inp, frame_xyz, M):
    """``path_m_chain``'s calls on the JAX package, the same keys."""
    out = {}
    world = [jnp.asarray(w) for w in inp["world"]]
    masks = [jnp.ones(len(w), bool) for w in world]
    origin = jnp.asarray(inp["origin"])
    S, leaf, depth = len(world), M["leaf"], M["depth"]
    qs = cs._m_queries(inp["world"], M)
    trees = [joc.build(world[k], masks[k], leaf, origin=origin, depth=depth) for k in range(S)]
    for k, tree in enumerate(trees):
        out[f"keys {k}"], out[f"order {k}"], out[f"mask {k}"] = (
            np.asarray(tree.keys), np.asarray(tree.order), np.asarray(tree.mask))
    for k in range(S - 1):
        out[f"change {k + 1}"] = np.asarray(joc.change_detection(trees[k + 1], trees[k]))
    dbo = JDouble(resolution=leaf, depth=depth, origin=inp["origin"])
    for k in range(S):
        if k:
            dbo.switch_buffers()
        dbo.set_cloud(world[k], masks[k])
        (out[f"new leaves {k}"], out[f"removed leaves {k}"], out[f"new points {k}"],
         out[f"xor {k}"]) = (dbo.new_leaf_keys(), dbo.removed_leaf_keys(),
                             dbo.new_point_indices(), dbo.xor_serialize())
    for k in range(S):
        q, jit, rays = (jnp.asarray(a) for a in qs[k])
        idx, valid = joc.voxel_search(trees[k], q, cap=M["voxel_cap"])
        out[f"voxel idx {k}"], out[f"voxel valid {k}"] = np.asarray(idx), np.asarray(valid)
        s = inp["sensors"][k]
        bidx, bvalid, bcount = joc.box_search(trees[k], jnp.asarray(s - M["box"] / 2),
                                              jnp.asarray(s + M["box"] / 2), world[k],
                                              cap=len(inp["world"][k]))
        out[f"box idx {k}"], out[f"box valid {k}"], out[f"box count {k}"] = (
            np.asarray(bidx), np.asarray(bvalid), int(bcount))
        out[f"occupied {k}"] = np.asarray(joc.is_voxel_occupied(trees[k], jit))
        c, n, nl = joc.leaf_centroids(trees[k], world[k])
        out[f"centroids {k}"], out[f"counts {k}"], out[f"leaves {k}"] = (
            np.asarray(c), np.asarray(n), int(nl))
        out[f"at_depth {k}"] = [int(joc.at_depth(trees[k], lv)[1].sum())
                                for lv in range(depth + 1)]
        keys, nbr, _ = joc.adjacency(trees[k])
        out[f"adjacency keys {k}"], out[f"adjacency {k}"] = np.asarray(keys), np.asarray(nbr)
        grid = joc.occupancy_from_tree(trees[k])
        nxt = (k + 1) % S
        grid2 = joc.set_occupied(grid, world[nxt], masks[nxt])
        out[f"grid {k}"], out[f"grid2 {k}"], out[f"grid2 n {k}"] = (
            np.asarray(grid.keys), np.asarray(grid2.keys), int(grid2.n_occupied))
        out[f"is_occupied {k}"] = np.asarray(joc.is_occupied(grid2, jit))
        o, d, L, steps = cs.m_rays(s, qs[k][2], M)
        rk, rv = joc.ray_intersected_voxels(trees[k], jnp.asarray(o), jnp.asarray(d), L,
                                            max_steps=steps)
        out[f"ray keys {k}"], out[f"ray valid {k}"] = np.asarray(rk), np.asarray(rv)
    for k in range(S - 1):
        xs = world[k][trees[k].order]
        ai, ad = joc.approx_nearest_search(trees[k], xs, world[k + 1])
        ei, ed = jbf.nn1(xs, trees[k].mask, world[k + 1])
        out[f"approx {k + 1}"] = (np.asarray(ai), np.asarray(ad))
        out[f"exact {k + 1}"] = (np.asarray(ei), np.asarray(ed))
    out["node counts"] = jit_.node_counts_per_depth(trees[0])
    out["preorder"] = sum(1 for _ in jit_.depth_first_iterator(trees[0]))
    res = math.radians(M["angular_deg"])
    out["images"] = []
    for k in range(S):
        ri = jri.create_from_cloud(jmake_cloud(jnp.asarray(inp["own"][k])), res, M["width"],
                                   M["height"])
        back = jri.to_cloud(ri)
        out[f"image {k}"], out[f"back {k}"], out[f"back mask {k}"] = (
            np.asarray(ri.ranges), np.asarray(back.xyz), np.asarray(back.mask))
        b = jfeat.extract_borders(ri)
        out[f"borders {k}"], out[f"border score {k}"] = (np.asarray(b.border_type),
                                                         np.asarray(b.border_score))
        rc, val, ok = jfeat.narf_keypoints(ri)
        out[f"keypoints {k}"] = (np.asarray(rc), np.asarray(val), np.asarray(ok))
        out[f"descriptors {k}"] = np.asarray(jfeat.narf_descriptors(ri, rc, **M["narf"]))
        out["images"].append(ri)
    Hh, Ww = frame_xyz.shape[:2]
    p = frame_xyz.reshape(-1, 3)
    fc = jmake_cloud(jnp.asarray(p), jnp.asarray(p[:, 2] > 0))
    out["planar"] = np.asarray(jri.create_planar_from_cloud(fc, M["planar_focal"], Ww, Hh).ranges)
    return out


@pytest.fixture(scope="module")
def chains():
    street = cs.make_street(n=cs.SCENE_POINTS // 4)
    scans, golden = trajectory.make_virtual_scan_sequence(
        street, 2, np.random.default_rng(0), **dict(cs.SEQUENCE_KW, max_points=SCAN_POINTS))
    inp = cs.path_m_inputs(scans, golden)
    frame = cs.path_l_frame(cs.L_SMALL)["xyz"]
    M = dict(cs.M_FULL, queries=512, rays=512, planar_focal=cs.L_SMALL["intr"][0])
    port, _ = cs.path_m_chain(inp, frame, M, torch.device("cpu"))
    return inp, frame, M, port, jax_chain(inp, frame, M)


EXACT = ("keys", "order", "mask", "change", "new leaves", "removed leaves", "new points", "xor",
         "voxel idx", "voxel valid", "box idx", "box valid", "box count", "occupied", "counts",
         "leaves", "at_depth", "adjacency", "grid", "is_occupied", "ray keys", "ray valid",
         "approx", "node counts", "preorder", "back mask")


def test_octree_tutorials_match_jax(chains):
    inp, _, _, port, ref = chains
    n = 0
    for key, a in port.items():
        if key.startswith(EXACT):
            b = ref[key]
            if isinstance(a, tuple):
                assert all(np.array_equal(x, y) for x, y in zip(a, b)), key
            else:
                assert np.array_equal(a, b), key
            n += 1
    assert n >= 50
    for k in range(2):
        scale = float(np.abs(inp["world"][k]).max())
        assert np.abs(port[f"centroids {k}"] - ref[f"centroids {k}"]).max() <= 1e-6 * scale
    # (g) B1's 1-NN and the JAX package's: the chosen points tie within the
    # rounding of the score
    xs = inp["world"][0][port["order 0"]].astype(np.float64)
    q = inp["world"][1].astype(np.float64)
    dp = ((q - xs[port["exact 1"][0]]) ** 2).sum(1)
    dj = ((q - xs[ref["exact 1"][0]]) ** 2).sum(1)
    slack = 2.0 ** -20 * ((q ** 2).sum(1) + (xs[ref["exact 1"][0]] ** 2).sum(1))
    assert (np.abs(dp - dj) <= slack).all()
    assert (port["exact 1"][0] == ref["exact 1"][0]).mean() >= 0.99


def test_range_images_and_narf_match_jax(chains):
    inp, frame, M, port, ref = chains
    for k in range(2):
        a, b = port[f"image {k}"], ref[f"image {k}"]
        check, _ = cs.edge_free_pixels(inp["own"][k], M, False, *b.shape)
        same = ((a == b) | (np.isneginf(a) & np.isneginf(b))).reshape(-1)
        assert same[check].all() and check.mean() > 0.99
        both = same & np.isfinite(b.reshape(-1))
        err = np.abs(port[f"back {k}"][both] - ref[f"back {k}"][both]).max(1)
        assert (err <= 1e-6 * b.reshape(-1)[both]).all()
        ri = ref["images"][k]
        timg = interop.range_image_from_arrays(
            np.asarray(ri.ranges), float(ri.angular_res), np.asarray(ri.center),
            np.asarray(ri.sensor_pose), ri.planar, device="cpu")
        tb = tfeat.extract_borders(timg)
        np.testing.assert_array_equal(tb.border_type.numpy(), ref[f"borders {k}"])
        np.testing.assert_array_equal(tb.border_score.numpy(), ref[f"border score {k}"])
        rc, val, ok = tfeat.narf_keypoints(timg)
        for x, y in zip((rc, val, ok), ref[f"keypoints {k}"]):
            np.testing.assert_array_equal(x.numpy(), y)
        d = tfeat.narf_descriptors(timg, rc, **M["narf"]).numpy()
        assert np.abs(d - ref[f"descriptors {k}"]).max() <= 1e-6
    p = frame.reshape(-1, 3)
    check, _ = cs.edge_free_pixels(p[p[:, 2] > 0], M, True, *ref["planar"].shape)
    a, b = port["planar"], ref["planar"]
    same = ((a == b) | (np.isneginf(a) & np.isneginf(b))).reshape(-1)
    assert same[check].all() and np.isfinite(b).sum() > 1000


def test_phase15_checks_pass_on_the_cpu_run(chains):
    """Phase 15's checks against numpy, rehearsed on the port's CPU run."""
    inp, frame, M, port, _ = chains
    failed, met = cs.path_m_checks(inp, frame, port, M)
    assert failed == []
    assert met["rays ending off their voxel 0"] <= 2 and 0 < met["exact share 1"] <= 1
    assert sum(met["nodes per depth"]) == port["preorder"]
