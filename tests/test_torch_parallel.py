"""Parity of pcl_tpu_torch.parallel (torch.distributed) with pcl_tpu.parallel
on the CPU.

The JAX side runs here on the 8 virtual CPU devices of ``tests/conftest.py``
(``make_mesh(8)``; the dryrun's sequence on ``make_mesh(4)`` at its own
shapes for 4 devices). The port's side runs in 2 and 4 gloo ranks: one spawn of
``tests/torch_parallel_worker.py`` per world size, every case in it, over a
``file://`` store; each rank saves its outputs. The cases mirror
``tests/test_parallel.py``.

Tolerances:
- a replicated output (poses, scores, raycast maps) is bitwise the same on
  every rank: each rank computes it from the same all-reduced sums;
- poses against the JAX package's sharded run: 1e-4 m and rad, float32 sums
  of other shard partitions (8 devices against 2 or 4 ranks) and a
  rotation by power iteration; NDT and GICP, whose loops amplify a rounding
  through 20-30 Newton or Gauss-Newton steps, 1e-3; the recovered motion to
  the JAX tests' own bounds;
- TSDF volumes under ROADMAP C27's exclusion (voxels whose projection lies
  within 1e-4 pixel of a half pixel), otherwise 1e-6; raycast hits equal and
  vertices within 1e-5 m.
"""
import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from pcl_tpu.core import transforms as jtf
from pcl_tpu.fusion import tsdf as jtsdf
from pcl_tpu.fusion import world_model as jwm
from pcl_tpu.parallel import gicp_sharded as jgicp
from pcl_tpu.parallel import graph_sharded as jgraph
from pcl_tpu.parallel import icp_sharded as jicp
from pcl_tpu.parallel import mesh as jmesh
from pcl_tpu.parallel import ndt_sharded as jndt
from pcl_tpu.parallel import runtime as jruntime
from pcl_tpu.parallel import tsdf_sharded as jtsh
from pcl_tpu.registration.graph import build_edges_from_correspondences

from pcl_tpu_torch import fusion as tfusion
from pcl_tpu_torch import parallel as tparallel
from pcl_tpu_torch.parallel import mesh as tmesh
from pcl_tpu_torch.parallel import runtime as truntime

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
WORLDS = (2, 4)
TOL = 1e-4
LOOP_TOL = 1e-3
H, W = 24, 32
_JAX = {}


def _se3(xi):
    return np.asarray(jtf.se3_exp(jnp.asarray(np.float32(xi))))


def _moved(pts, T):
    return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def _graph(rng, V, C, step):
    scene = rng.normal(size=(C, 3)).astype(np.float32)
    true = [np.eye(4, dtype=np.float32)]
    for _ in range(V - 1):
        true.append(true[-1] @ _se3(rng.normal(size=6) * step))
    scans = [_moved(scene, np.linalg.inv(T)) for T in true]
    pairs = [(i, j, scans[i], scans[j]) for i in range(V) for j in range(i + 1, V)]
    es, ed, cs, cd, cv = (np.asarray(a) for a in build_edges_from_correspondences(pairs, C))
    return np.stack(true), es, ed, cs, cd, cv


def _inputs():
    """Every case's inputs, made from seeds with numpy (as
    ``tests/test_parallel.py`` makes them)."""
    from __graft_entry__ import _synthetic_pair

    rng = np.random.default_rng(42)
    d = {}
    pts = rng.uniform(-1, 1, size=(1024, 3)).astype(np.float32)
    d["icp/T_true"] = _se3([0.03, -0.02, 0.01, 0.02, 0.01, -0.03])
    d["icp/src"], d["icp/dst"] = pts, _moved(pts, d["icp/T_true"])

    xy = rng.uniform(-1, 1, size=(512, 2)).astype(np.float32)
    z = 0.3 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    nrm = np.column_stack([-0.6 * np.cos(2 * xy[:, 0]) * np.cos(2 * xy[:, 1]),
                           0.6 * np.sin(2 * xy[:, 0]) * np.sin(2 * xy[:, 1]),
                           np.ones(512)]).astype(np.float32)
    d["p2pl/normals"] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    d["p2pl/delta"] = np.float32([0.01, -0.02, 0.03])
    d["p2pl/src"], d["p2pl/dst"] = pts, pts + d["p2pl/delta"]

    xy = rng.uniform(-1, 1, size=(1024, 2)).astype(np.float32)
    pts = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(2 * xy[:, 1])])
    pts = pts.astype(np.float32)
    d["gicp/T_true"] = _se3([0.02, -0.01, 0.015, 0.01, -0.02, 0.015])
    d["gicp/src"], d["gicp/dst"] = pts, _moved(pts, d["gicp/T_true"])

    pts = rng.uniform(0.0, 6.4, size=(8192, 3)).astype(np.float32)
    d["blocked/delta"] = np.float32([0.004, -0.003, 0.005])
    d["blocked/src"], d["blocked/dst"] = pts, pts + d["blocked/delta"]

    centers = rng.uniform(-4, 4, size=(24, 3)).astype(np.float32)
    pts = (centers[rng.integers(0, 24, 2048)]
           + rng.normal(scale=0.4, size=(2048, 3))).astype(np.float32)
    d["ndt/T_true"] = _se3([0.08, -0.05, 0.06, 0.02, -0.015, 0.025])
    d["ndt/src"], d["ndt/dst"] = pts, _moved(pts, d["ndt/T_true"])

    pts = rng.uniform(-1, 1, size=(2048, 3)).astype(np.float32)
    d["cellpair/T_true"] = _se3([0.02, -0.01, 0.015, 0.01, -0.02, 0.01])
    d["cellpair/src"], d["cellpair/dst"] = pts, _moved(pts, d["cellpair/T_true"])

    pts = rng.uniform(-1, 1, size=(512, 3)).astype(np.float32)
    d["hybrid/T_true"] = _se3([0.05, -0.02, 0.03, 0.1, -0.05, 0.02])
    d["hybrid/src"], d["hybrid/dst"] = pts, _moved(pts, d["hybrid/T_true"])

    true, *edges = _graph(rng, 5, 150, 0.2)
    init = true.copy()
    for v in range(1, 5):
        init[v] = _se3(rng.normal(size=6) * 0.05) @ init[v]
    d["lum/true"], d["lum/init"] = true, init
    d.update({f"lum/{k}": e for k, e in zip(("es", "ed", "cs", "cd", "cv"), edges)})

    d["tsdf/depth"] = np.full((H, W), 1.2, np.float32)

    # __graft_entry__.dryrun_multichip's inputs for 4 devices
    for n in (4,):
        s, _, t, _ = _synthetic_pair(n_src=128 * n, n_tgt=256, seed=1)
        d[f"dry{n}/src"], d[f"dry{n}/dst"] = np.asarray(s), np.asarray(t)
        tgt = np.random.default_rng(7).uniform(0.0, 6.4, size=(2048 * n, 3)).astype(np.float32)
        d[f"dryb{n}/src"] = tgt + np.float32([0.004, -0.003, 0.005])
        d[f"dryb{n}/dst"] = tgt
    rng3 = np.random.default_rng(3)
    true, *edges = _graph(rng3, 4, 64, 0.1)
    init = true.copy()
    init[1] = _se3([0.02, -0.01, 0.01, 0.01, 0.02, -0.01]) @ init[1]
    d["dry/init"] = init
    d.update({f"dry/{k}": e for k, e in zip(("es", "ed", "cs", "cd", "cv"), edges)})
    return d


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    """``{world: [outputs of rank 0, rank 1, ...]}``: the worker spawned
    once per world size, all spawns at once; a rank that fails or does not
    finish in time fails the fixture."""
    base = tmp_path_factory.mktemp("ranks")
    np.savez(base / "inputs.npz", **inputs)
    procs = []
    for w in WORLDS:
        (base / f"w{w}").mkdir()
        for r in range(w):
            env = dict(os.environ, PCL_TPU_NPROCS=str(w), PCL_TPU_PROC_ID=str(r),
                       OMP_NUM_THREADS="1")
            env.pop("PCL_TPU_COORDINATOR", None)
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(base / f"w{w}" / "store"),
                 str(base / "inputs.npz"), str(base / f"w{w}")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            p.kill()
    return {w: [dict(np.load(base / f"w{w}" / f"rank{r}.npz")) for r in range(w)]
            for w in WORLDS}, base


def _out(ranks, w, key):
    return ranks[0][w][0][key]


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8)


def _sharded(mesh, name, d, axis="points"):
    src, dst = jnp.asarray(d[f"{name}/src"]), jnp.asarray(d[f"{name}/dst"])
    return (jax.device_put(src, NamedSharding(mesh, P(axis, None))),
            jax.device_put(jnp.ones(len(src), bool), NamedSharding(mesh, P(axis))),
            jax.device_put(dst, NamedSharding(mesh, P())),
            jax.device_put(jnp.ones(len(dst), bool), NamedSharding(mesh, P())))


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = jax.tree.map(np.asarray, fn())
    return _JAX[key]


def _pose_gap(a, b):
    E = np.linalg.inv(np.asarray(b, np.float64)) @ np.asarray(a, np.float64)
    R = E[:3, :3]
    # atan2 of the skew and symmetric parts stays accurate at tiny angles
    skew = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    ang = np.arctan2(np.linalg.norm(skew), 0.5 * (np.trace(R) - 1))
    return float(np.linalg.norm(E[:3, 3])), float(ang)


def _close_pose(a, b, tol):
    dt, dr = _pose_gap(a, b)
    assert dt <= tol and dr <= tol, (dt, dr)


@pytest.mark.parametrize("w", WORLDS)
def test_replicated_outputs_are_equal_on_every_rank(ranks, w):
    outs = ranks[0][w]
    assert int(outs[0]["world"]) == w and str(outs[0]["backend"]) == "gloo"
    for key, v in outs[0].items():
        if key.startswith(("icp/", "p2pl/", "gicp/", "blocked/", "ndt/", "cellpair/", "lum/",
                           "tsdf/verts", "tsdf/normals", "tsdf/hit", "tsdf/tsdf", "shift/",
                           "world/", "dry/", "hybrid/T", "hybrid/info")):
            for r in range(1, w):
                np.testing.assert_array_equal(outs[r][key], v, err_msg=key)
    assert list(outs[0]["tsdf/slab"]) == [64 // w, 64, 64]


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_icp_matches_jax(ranks, inputs, mesh8, w):
    want = _jax("icp", lambda: jicp.sharded_icp(mesh8, *_sharded(mesh8, "icp", inputs),
                                                max_iterations=25))
    T = _out(ranks, w, "icp/T")
    _close_pose(T, want[0], TOL)
    np.testing.assert_allclose(T, inputs["icp/T_true"], atol=2e-3)
    assert int(_out(ranks, w, "icp/it")) == 25
    # one all-reduce of 18 floats an iteration
    assert list(_out(ranks, w, "icp/counts/psum")) == [25, 25 * 18 * 4]


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_icp_step_matches_jax(ranks, inputs, mesh8, w):
    """One iteration of ``sharded_icp_step`` from the identity."""
    def run():
        step = jicp.sharded_icp_step(mesh8)
        src, sm, tgt, tm = _sharded(mesh8, "icp", inputs)
        return jax.jit(step)(src, sm, tgt, tm, jnp.zeros_like(tgt), jnp.eye(4),
                             jnp.float32(jnp.inf))
    want = _jax("icp_step", run)
    _close_pose(_out(ranks, w, "icp/step_T"), want[0], TOL)
    np.testing.assert_allclose(_out(ranks, w, "icp/step_mse"), want[1], rtol=1e-5)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_icp_point_to_plane_matches_jax(ranks, inputs, mesh8, w):
    d = inputs
    want = _jax("p2pl", lambda: jicp.sharded_icp(
        mesh8, *_sharded(mesh8, "p2pl", d),
        tgt_normals=jax.device_put(jnp.asarray(d["p2pl/normals"]), NamedSharding(mesh8, P())),
        max_iterations=15, variant="point_to_plane"))
    T = _out(ranks, w, "p2pl/T")
    _close_pose(T, want[0], TOL)
    np.testing.assert_allclose(T[:3, 3], d["p2pl/delta"], atol=2e-3)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_gicp_matches_jax(ranks, inputs, mesh8, w):
    want = _jax("gicp", lambda: jgicp.sharded_gicp(
        mesh8, *_sharded(mesh8, "gicp", inputs), max_corr_dist=0.5, max_iterations=20,
        k_covariances=12))
    T = _out(ranks, w, "gicp/T")
    _close_pose(T, want[0], LOOP_TOL)
    np.testing.assert_allclose(T, inputs["gicp/T_true"], atol=3e-3)


@pytest.mark.parametrize("w", WORLDS)
def test_cell_blocked_matches_jax(ranks, inputs, mesh8, w):
    """The JAX package serves it with the windowed span sweep, the port with
    ``nn1_radius`` on the same dense table (ROADMAP C6)."""
    want = _jax("blocked", lambda: jicp.sharded_icp(
        mesh8, *_sharded(mesh8, "blocked", inputs), max_corr_dist=0.05, max_iterations=5,
        corr_backend="cell_blocked", cell_cap=12, grid_dims=(64, 64, 64)))
    T = _out(ranks, w, "blocked/T")
    _close_pose(T, want[0], TOL)
    np.testing.assert_allclose(T[:3, 3], inputs["blocked/delta"], atol=5e-4)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_ndt_matches_jax(ranks, inputs, mesh8, w):
    kw = dict(resolution=1.5, max_iterations=30, step_size=0.5, table_size=1 << 14,
              min_points=4)
    want = _jax("ndt", lambda: jndt.sharded_ndt(mesh8, *_sharded(mesh8, "ndt", inputs), **kw))
    T = _out(ranks, w, "ndt/T")
    _close_pose(T, want[0], LOOP_TOL)
    np.testing.assert_allclose(T, inputs["ndt/T_true"], atol=2e-2)
    np.testing.assert_allclose(_out(ranks, w, "ndt/score"), want[1], rtol=1e-4)
    # a 43-float all-reduce and a 1-float one an iteration (and 7 floats on a
    # backtracking iteration), and 1 float for the valid count
    it = int(_out(ranks, w, "ndt/it"))
    calls, nbytes = _out(ranks, w, "ndt/counts/psum")
    back = calls - 2 * it - 1
    assert back >= 0 and nbytes == 4 * (44 * it + 7 * back + 1)


@pytest.mark.parametrize("w", WORLDS)
def test_cell_backend_matches_brute_and_jax(ranks, inputs, mesh8, w):
    want = _jax("cellpair", lambda: jicp.sharded_icp(
        mesh8, *_sharded(mesh8, "cellpair", inputs), max_iterations=20, max_corr_dist=0.12,
        corr_backend="cell", cell_cap=32))
    Tc, Tb = _out(ranks, w, "cellpair/cell/T"), _out(ranks, w, "cellpair/brute/T")
    _close_pose(Tc, want[0], TOL)
    np.testing.assert_allclose(Tc, inputs["cellpair/T_true"], atol=2e-3)
    np.testing.assert_allclose(Tc, Tb, atol=5e-4)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_lum_matches_jax(ranks, inputs, mesh8, w):
    d = inputs
    want = _jax("lum", lambda: jgraph.sharded_lum(
        mesh8, jnp.asarray(d["lum/init"]), *(d[f"lum/{k}"] for k in ("es", "ed", "cs", "cd",
                                                                     "cv")),
        max_iterations=6, cg_iters=64))
    poses = _out(ranks, w, "lum/poses")
    for a, b in zip(poses, want.poses):
        _close_pose(a, b, TOL)
    assert float(_out(ranks, w, "lum/residual")) < 1e-5
    # per Gauss-Newton iteration one all-reduce of gradient and blocks and
    # one per CG step; one for the residual at the end
    V = poses.shape[0]
    calls, nbytes = _out(ranks, w, "lum/counts/psum")
    assert calls == 6 * (1 + 64) + 1
    assert nbytes == 4 * (6 * (42 * V + 64 * 6 * V) + 2)


def _jax_wall_volume(mesh, depth, res=64):
    vol = jtsdf.make_volume(resolution=res, size=3.2, origin=jnp.asarray([-1.6, -1.6, 0.0]))
    intr = jtsdf.Intrinsics(fx=32.0, fy=32.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    return jtsh.integrate_sharded(mesh, vol, jnp.asarray(depth), intr, jnp.eye(4)), intr


def _half_pixel_voxels(res, origin, voxel, intr, n=64):
    """C27: voxels whose projection lies within 1e-4 pixel of a half
    pixel (the identity pose)."""
    c = origin + (np.arange(res, dtype=np.float64) + 0.5) * voxel
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    Zs = np.maximum(Z, 1e-9)
    u = intr.fx * X / Zs + intr.cx
    v = intr.fy * Y / Zs + intr.cy
    near = lambda a: np.abs(a - np.floor(a) - 0.5) < 1e-4  # noqa: E731
    return near(u) | near(v)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_integrate_matches_jax(ranks, inputs, mesh8, w):
    vol, intr = _jax("tsdf_vol", lambda: _jax_wall_volume(mesh8, inputs["tsdf/depth"]))
    skip = _half_pixel_voxels(64, -1.6, 3.2 / 64, intr)
    for name in ("tsdf", "weight"):
        got = _out(ranks, w, f"tsdf/{name}")
        want = np.asarray(getattr(vol, name))
        np.testing.assert_allclose(got[~skip], want[~skip], rtol=0, atol=1e-6)
    assert float(_out(ranks, w, "tsdf/weight").sum()) > 0


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_raycast_matches_jax_and_replicated(ranks, inputs, mesh8, w):
    vol, intr = _jax("tsdf_vol", lambda: _jax_wall_volume(mesh8, inputs["tsdf/depth"]))
    kw = dict(near=0.2, far=2.5, n_steps=128)
    v2, n2, h2 = _jax("raycast", lambda: jtsh.raycast_sharded(
        mesh8, vol, intr, jnp.eye(4, dtype=jnp.float32), H, W, **kw))
    hit = _out(ranks, w, "tsdf/hit")
    np.testing.assert_array_equal(hit, h2)
    assert hit.sum() > 50
    np.testing.assert_allclose(_out(ranks, w, "tsdf/verts"), v2, rtol=0, atol=1e-5)
    dn = np.sum(_out(ranks, w, "tsdf/normals")[hit] * n2[hit], -1)
    assert np.median(dn) > 1 - 1e-5
    # and the port's replicated raycast on the whole volume (its own arithmetic)
    tvol = tfusion.TSDFVolume(
        tsdf=torch.from_numpy(_out(ranks, w, "tsdf/tsdf")),
        weight=torch.from_numpy(_out(ranks, w, "tsdf/weight")),
        origin=torch.tensor([-1.6, -1.6, 0.0]), voxel_size=torch.tensor(3.2 / 64),
        trunc=torch.tensor(7 * 3.2 / 64))
    v1, _, h1 = tfusion.raycast(tvol, tfusion.Intrinsics(32.0, 32.0, W / 2 - 0.5, H / 2 - 0.5),
                               torch.eye(4), H, W, **kw)
    np.testing.assert_array_equal(h1.numpy(), hit)
    np.testing.assert_allclose(v1.numpy(), _out(ranks, w, "tsdf/verts"), rtol=0, atol=1e-5)


@pytest.mark.parametrize("w", WORLDS)
def test_shift_and_world_model_roundtrip(ranks, w):
    t0, w0 = _out(ranks, w, "tsdf/tsdf"), _out(ranks, w, "tsdf/weight")
    Rl = 64 // w
    np.testing.assert_array_equal(_out(ranks, w, "shift/ev_t"), t0[:Rl])
    np.testing.assert_array_equal(_out(ranks, w, "shift/ev_w"), w0[:Rl])
    np.testing.assert_array_equal(_out(ranks, w, "shift/tsdf")[:-Rl], t0[Rl:])
    assert (_out(ranks, w, "shift/tsdf")[-Rl:] == 1).all()
    assert float(_out(ranks, w, "shift/weight")[-Rl:].sum()) == 0.0
    np.testing.assert_allclose(_out(ranks, w, "shift/origin")[0]
                               - _out(ranks, w, "shift/ev_origin")[0], Rl * 3.2 / 64,
                               rtol=1e-6)
    np.testing.assert_array_equal(_out(ranks, w, "world/t"), t0[:Rl])
    np.testing.assert_array_equal(_out(ranks, w, "world/w"), w0[:Rl])


def test_tsdf_save_load_across_packages(ranks, mesh8, inputs, tmp_path):
    """The volume the port's ranks integrated, saved by rank 0, reads back in
    the JAX package bit for bit, and the JAX package's in the port."""
    j = jwm.load_tsdf(str(ranks[1] / "w2" / "port_vol.npz"))
    np.testing.assert_array_equal(np.asarray(j.tsdf), _out(ranks, 2, "tsdf/tsdf"))
    vol, _ = _jax("tsdf_vol", lambda: _jax_wall_volume(mesh8, inputs["tsdf/depth"]))
    p = str(tmp_path / "jax_vol.npz")
    jwm.save_tsdf(p, vol)
    t = tfusion.load_tsdf(p, device="cpu")
    np.testing.assert_array_equal(t.weight.numpy(), np.asarray(vol.weight))
    assert float(t.voxel_size) == float(vol.voxel_size)


def test_hybrid_mesh_shapes_and_icp(ranks, inputs):
    """Four ranks as dcn 2 x ici 2; 3 host groups raise; ICP over both axes;
    the single axes reduce over their own groups (ranks 0,1 | 2,3 along ici,
    0,2 | 1,3 along dcn)."""
    outs = ranks[0][4]
    assert list(outs[0]["hybrid/info"]) == [2, 2] and bool(outs[0]["hybrid/raises"])
    hmesh = jruntime.hybrid_mesh(dcn_size=2)
    want = _jax("hybrid", lambda: jicp.sharded_icp(
        hmesh, *_sharded(hmesh, "hybrid", inputs, axis=("dcn", "ici")), max_iterations=25,
        axis=("dcn", "ici")))
    _close_pose(outs[0]["hybrid/T"], want[0], TOL)
    np.testing.assert_allclose(outs[0]["hybrid/T"], inputs["hybrid/T_true"], atol=2e-3)
    assert [float(o["hybrid/ici_sum"][0]) for o in outs] == [1.0, 1.0, 5.0, 5.0]
    assert [list(o["hybrid/dcn_gather"]) for o in outs] == [[0, 2], [1, 3], [0, 2], [1, 3]]


def _jax_dryrun(n):
    """``dryrun_multichip``'s sharded calls on ``make_mesh(n)``."""
    mesh = jmesh.make_mesh(n)
    d = _inputs()
    args = _sharded(mesh, f"dry{n}", d)
    out = {"icp": jicp.sharded_icp(mesh, *args, max_corr_dist=0.5, max_iterations=3)[0]}
    nrm = jnp.tile(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (256, 1))
    out["p2pl"] = jicp.sharded_icp(mesh, *args, tgt_normals=nrm, max_corr_dist=0.5,
                                   max_iterations=2, variant="point_to_plane")[0]
    vol = jtsdf.make_volume(resolution=8 * n, size=2.0, origin=jnp.asarray([-1.0, -1.0, 0.0]))
    intr = jtsdf.Intrinsics(fx=32.0, fy=32.0, cx=16.0, cy=12.0)
    vol2 = jtsh.integrate_sharded(mesh, vol, jnp.full((24, 32), 1.0, jnp.float32), intr,
                                  jnp.eye(4))
    out["tsdf"] = vol2.tsdf
    out["verts"], _, out["hit"] = jtsh.raycast_sharded(
        mesh, vol2, intr, jnp.eye(4, dtype=jnp.float32), 24, 32, far=2.0, n_steps=64)
    vol3, out["ev_t"], _, _ = jtsh.shift_sharded(mesh, vol2)
    out["origin3"] = vol3.origin
    out["gicp"] = jgicp.sharded_gicp(mesh, *args, max_corr_dist=0.5, max_iterations=2,
                                     k_covariances=8)[0]
    r = jgraph.sharded_lum(mesh, jnp.asarray(d["dry/init"]),
                           *(d[f"dry/{k}"] for k in ("es", "ed", "cs", "cd", "cv")),
                           max_iterations=2, cg_iters=16)
    out["lum"], out["lum_res"] = r.poses, r.residual
    out["ndt"] = jndt.sharded_ndt(mesh, *args, resolution=0.5, max_iterations=3,
                                  table_size=1 << 12, min_points=3)[0]
    out["blocked"] = jicp.sharded_icp(mesh, *_sharded(mesh, f"dryb{n}", d), max_corr_dist=0.05,
                                      max_iterations=2, corr_backend="cell_blocked",
                                      cell_cap=12, grid_dims=(64, 64, 64))[0]
    return out


def test_dryrun_sequence_matches_jax(ranks):
    """``__graft_entry__.dryrun_multichip``'s sequence at its shapes for 4
    devices, the port's 4 ranks against the JAX functions."""
    w = 4
    want = _jax(f"dry{w}", lambda: _jax_dryrun(w))
    for key in ("icp", "p2pl", "blocked"):
        _close_pose(_out(ranks, w, f"dry/{key}"), want[key], TOL)
    for key in ("gicp", "ndt"):
        _close_pose(_out(ranks, w, f"dry/{key}"), want[key], LOOP_TOL)
    for a, b in zip(_out(ranks, w, "dry/lum"), want["lum"]):
        _close_pose(a, b, TOL)
    np.testing.assert_allclose(_out(ranks, w, "dry/lum_res"), want["lum_res"], rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(_out(ranks, w, "dry/tsdf"), want["tsdf"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_out(ranks, w, "dry/hit"), want["hit"])
    np.testing.assert_allclose(_out(ranks, w, "dry/verts"), want["verts"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_out(ranks, w, "dry/ev_t"), np.asarray(want["tsdf"])[:8])
    np.testing.assert_allclose(_out(ranks, w, "dry/origin3"), want["origin3"], rtol=0,
                               atol=1e-6)


def test_initialize_single_process_noop(monkeypatch):
    for k in ("PCL_TPU_COORDINATOR", "PCL_TPU_NPROCS", "PCL_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert truntime.initialize_multihost() is False
    assert not dist.is_initialized()


@pytest.fixture
def one_rank_group():
    """A process without a group: ``make_mesh`` forms a one-rank gloo
    group; destroyed afterwards."""
    assert not dist.is_initialized()
    yield tmesh.make_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_group_belongs_to_its_mesh(one_rank_group, tmp_path):
    """The mesh that formed the one-rank group owns it; a mesh made while a
    group exists does not, and ``initialize_multihost`` refuses to join a
    group of another size or rank."""
    m = one_rank_group
    assert m.owns_group
    other = tmesh.make_mesh(device="cpu")
    assert not other.owns_group
    other.close()
    assert dist.is_initialized()
    store = f"file://{tmp_path}/store"
    with pytest.raises(RuntimeError, match="group of 1"):
        truntime.initialize_multihost(init_method=store, num_processes=2, process_id=0)
    with pytest.raises(RuntimeError, match="rank 0"):
        truntime.initialize_multihost(init_method=store, num_processes=1, process_id=1)
    assert truntime.initialize_multihost(init_method=store, num_processes=1,
                                         process_id=0) is False
    m.close()
    assert not dist.is_initialized()
    m.close()


def test_one_rank_mesh_runs_the_collectives(one_rank_group, inputs):
    m = one_rank_group
    assert m.shape == {"points": 1} and m.backend == "gloo" and m.device.type == "cpu"
    with pytest.raises(ValueError, match="process group"):
        tparallel.make_mesh(2, device="cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    np.testing.assert_array_equal(tmesh._psum(m, x, "points").numpy(), x.numpy())
    np.testing.assert_array_equal(tmesh.gather_shards(m, x).numpy(), x.numpy())
    got, = tmesh._ppermute(m, [x], "points", [(0, 0)])
    np.testing.assert_array_equal(got.numpy(), x.numpy())
    assert {k: v[0] for k, v in m.counts.items()} == {"psum": 1, "all_gather": 1,
                                                      "ppermute": 1}
    # a cloud's shard of one rank is the whole cloud, padded to the axis
    from pcl_tpu_torch.core.cloud import make_cloud
    c = tparallel.shard_cloud(make_cloud(inputs["icp/src"][:5], device="cpu"), m)
    assert c.capacity == 5 and bool(c.mask.all())
    tree = tmesh.replicate({"a": x, "b": [x, 3]}, m)
    assert tree["a"].device == m.device and tree["b"][1] == 3


def test_checkpointed_poses_resume_across_packages(tmp_path):
    """Each package resumes from the other's journal, torn last line
    included."""
    for writer, reader in ((truntime, jruntime), (jruntime, truntime)):
        p = str(tmp_path / f"{writer.__name__}.jsonl")
        ck = writer.CheckpointedPoses(p)
        nxt0, pose0 = ck.resume()
        assert nxt0 == 0
        np.testing.assert_allclose(pose0, np.eye(4))
        T0 = np.eye(4, dtype=np.float32)
        T0[0, 3] = 1.0
        T1 = np.eye(4, dtype=np.float32)
        T1[1, 3] = 2.0
        ck.commit(0, T0)
        ck.commit(1, torch.from_numpy(T1) if writer is truntime else T1)
        with open(p, "a") as f:
            f.write('{"frame": 2, "pose": [1.0, 0')
        other = reader.CheckpointedPoses(p)
        nxt, pose = other.resume()
        assert nxt == 2
        np.testing.assert_array_equal(pose, T1)
        assert len(other.poses()) == 2
        with open(p) as f:
            assert json.loads(f.readline()) == {"frame": 0, "pose": T0.reshape(-1).tolist()}


def test_lazy_exports_match_jax():
    import pcl_tpu.parallel as jpar
    assert tparallel.__all__ == jpar.__all__
    for name in tparallel.__all__:
        assert callable(getattr(tparallel, name))
    with pytest.raises(AttributeError):
        tparallel.nope
