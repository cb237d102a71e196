"""Parity of pcl_tpu_torch.registration.graph and .graph_optimizer with the
JAX package's pose graph on the CPU, at the JAX tests' sizes (V <= 16).

Tolerances, stated where each is checked:

- ``_skew``: equal to ``transforms.hat`` and to the JAX function, exactly;
- the per-edge 6x6 blocks and gradients: 1e-5 of their largest entry;
- ``lum`` dense and CG: poses within 1e-4 m and 1e-4 rad, iterations equal,
  residual within 1e-4 relative. LAPACK on the CPU and XLA round the dense
  solve with its 1e12 gauge prior differently, so the poses are compared to a
  tolerance, not bitwise;
- ``elch_distribute``: 1e-5;
- ``build_edges_from_correspondences``: equal arrays;
- ``PoseGraph`` backends: the same names, poses as ``lum``'s tolerance.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core import transforms as jtf
from pcl_tpu.registration import graph as jg
from pcl_tpu.registration import graph_optimizer as jgo
from pcl_tpu.registration.gicp import _skew as j_skew

from pcl_tpu_torch.core import transforms as ttf
from pcl_tpu_torch.registration import graph as tg
from pcl_tpu_torch.registration import graph_optimizer as tgo
from pcl_tpu_torch.registration.gicp import _skew as t_skew

# the built-in backends, read before any test registers another
JAX_BACKENDS = sorted(jgo._REGISTRY)
TOL_M, TOL_RAD = 1e-4, 1e-4


def _pose(rng, rot, trans):
    xi = np.concatenate([rng.normal(size=3) * trans, rng.normal(size=3) * rot])
    return np.asarray(jtf.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)


def _graph(rng, V, loops, C=200, n_valid=None, noise=0.01):
    """V scans of one scene along a chain of random steps, edges between
    consecutive scans plus ``loops``; correspondences the same scene points
    seen from both poses plus noise, ``n_valid`` of ``C`` per edge."""
    scene = rng.normal(scale=3.0, size=(400, 3))
    true = [np.eye(4)]
    for _ in range(V - 1):
        true.append(true[-1] @ _pose(rng, 0.1, 0.5))
    edges = [(i, i + 1) for i in range(V - 1)] + list(loops)
    pairs = []
    for i, j in edges:
        k = rng.choice(len(scene), size=n_valid or C, replace=False)
        p = scene[k]
        ti, tj = np.linalg.inv(true[i]), np.linalg.inv(true[j])
        src = p @ ti[:3, :3].T + ti[:3, 3]
        dst = p @ tj[:3, :3].T + tj[:3, 3] + rng.normal(scale=noise, size=p.shape)
        pairs.append((i, j, src.astype(np.float32), dst.astype(np.float32)))
    init = [true[0]] + [_pose(rng, 0.01, 0.05) @ t for t in true[1:]]
    return np.stack(init).astype(np.float32), pairs, C


def _gap(a, b):
    """Largest translation (m) and rotation (rad) between two pose stacks."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    R = np.einsum("vij,vkj->vik", a[:, :3, :3], b[:, :3, :3])
    # atan2 of the skew and symmetric parts stays accurate at tiny angles
    skew = 0.5 * np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                           R[:, 1, 0] - R[:, 0, 1]], -1)
    ang = np.arctan2(np.linalg.norm(skew, axis=-1), 0.5 * (np.trace(R, axis1=1, axis2=2) - 1))
    return float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max()), float(ang.max())


def test_skew_is_hat(rng):
    v = rng.normal(size=(5, 7, 3)).astype(np.float32)
    t = torch.from_numpy(v)
    assert t_skew is ttf.hat
    assert torch.equal(t_skew(t), ttf.hat(t))
    np.testing.assert_array_equal(t_skew(t).numpy(), np.asarray(j_skew(jnp.asarray(v))))


def test_build_edges_matches_jax(rng):
    _, pairs, C = _graph(rng, 5, [(0, 4)], n_valid=150)
    pairs[2] = pairs[2][:2] + (pairs[2][2][:300 - 180], pairs[2][3][:300 - 180])
    j = jg.build_edges_from_correspondences(pairs, 128)
    t = tg.build_edges_from_correspondences(pairs, 128, device="cpu")
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_edge_system_matches_jax(rng):
    P, pairs, C = _graph(rng, 6, [(0, 5), (1, 4)], n_valid=170)
    j = jg.build_edges_from_correspondences(pairs, C)
    t = tg.build_edges_from_correspondences(pairs, C, device="cpu")
    out_j = jg._edge_system(jnp.asarray(P), *j)
    out_t = tg._edge_system(torch.from_numpy(P), t[0].long(), t[1].long(), *t[2:])
    for a, b in zip(out_j, out_t):
        a = np.asarray(a)
        # 1e-5 of the largest entry: float32 sums of 170 products
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5 * max(1.0, float(np.abs(a).max())))


@pytest.mark.parametrize("V,loops,n_valid", [
    (4, [(0, 3)], None),                 # the JAX test's chain with its loop edge
    (8, [(0, 7), (2, 6)], 150),          # padded correspondences (150 of 200)
    (16, [(0, 15), (3, 12), (5, 10)], None),
])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_lum_matches_jax(rng, V, loops, n_valid, solver):
    P, pairs, C = _graph(rng, V, loops, n_valid=n_valid)
    j = jg.build_edges_from_correspondences(pairs, C)
    t = tg.build_edges_from_correspondences(pairs, C, device="cpu")
    kw = dict(max_iterations=6, solver=solver)
    rj = jg.lum(jnp.asarray(P), *j, **kw)
    rt = tg.lum(torch.from_numpy(P), *t, **kw)
    gap_t, gap_r = _gap(rt.poses.numpy(), rj.poses)
    assert gap_t <= TOL_M and gap_r <= TOL_RAD, (gap_t, gap_r)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(float(rt.residual), float(rj.residual), rtol=1e-4, atol=1e-9)
    assert rt.poses.dtype == torch.float32 and rt.iterations.dtype == torch.int32


def test_lum_stops_at_threshold_as_jax(rng):
    """The residual test ends the loop after the same number of iterations."""
    P, pairs, C = _graph(rng, 6, [(0, 5)], noise=0.0)
    j = jg.build_edges_from_correspondences(pairs, C)
    t = tg.build_edges_from_correspondences(pairs, C, device="cpu")
    kw = dict(max_iterations=20, convergence_threshold=1e-8)
    rj = jg.lum(jnp.asarray(P), *j, **kw)
    rt = tg.lum(torch.from_numpy(P), *t, **kw)
    assert int(rt.iterations) == int(rj.iterations) < 20
    gap_t, gap_r = _gap(rt.poses.numpy(), rj.poses)
    assert gap_t <= TOL_M and gap_r <= TOL_RAD


def test_lum_rejects_unknown_solver():
    with pytest.raises(ValueError, match="solver"):
        tg.lum(torch.eye(4)[None], torch.zeros(0, dtype=torch.int32),
               torch.zeros(0, dtype=torch.int32), torch.zeros(0, 1, 3), torch.zeros(0, 1, 3),
               torch.zeros(0, 1, dtype=torch.bool), solver="qr")


@pytest.mark.parametrize("V", [2, 5, 12])
def test_elch_distribute_matches_jax(rng, V):
    poses = np.stack([_pose(rng, 0.2, 1.0) for _ in range(V)]).astype(np.float32)
    loop = _pose(rng, 0.3, 0.5).astype(np.float32)
    j = np.asarray(jg.elch_distribute(jnp.asarray(poses), jnp.asarray(loop)))
    t = tg.elch_distribute(torch.from_numpy(poses), torch.from_numpy(loop)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_backend_names_match_jax():
    assert sorted(tgo._REGISTRY) == JAX_BACKENDS


def _pose_graph(mod, P, pairs):
    g = mod.PoseGraph()
    for p in P:
        g.add_vertex(p)
    for i, j, s, d in pairs:
        g.add_edge(i, j, s, d)
    return g


@pytest.mark.parametrize("method,kw", [
    ("lum", dict(max_iterations=4)),
    ("lum_cg", dict(max_iterations=4, cg_iters=64)),
    ("lum", dict(max_iterations=4, max_corr=120)),
])
def test_pose_graph_backends_match_jax(rng, method, kw):
    P, pairs, _ = _graph(rng, 6, [(0, 5)], n_valid=140)
    j = _pose_graph(jgo, P, pairs).optimize(method, **kw)
    g = _pose_graph(tgo, P, pairs)
    t = g.optimize(method, device="cpu", **kw)
    assert isinstance(t, np.ndarray) and t.shape == (6, 4, 4)
    np.testing.assert_array_equal(g.poses(), t)
    gap_t, gap_r = _gap(t, j)
    assert gap_t <= TOL_M and gap_r <= TOL_RAD


def test_pose_graph_elch_matches_jax():
    g_j, g_t = jgo.PoseGraph(), tgo.PoseGraph()
    for _ in range(4):
        g_j.add_vertex()
        g_t.add_vertex()
    loop = np.asarray(jtf.se3_exp(jnp.asarray([0.4, 0.0, 0.1, 0.0, 0.05, 0.0], jnp.float32)))
    np.testing.assert_allclose(g_t.optimize("elch", loop_transform=loop, device="cpu"),
                               g_j.optimize("elch", loop_transform=loop), atol=1e-5)
    with pytest.raises(ValueError, match="loop_transform"):
        g_t.optimize("elch", device="cpu")


def test_pose_graph_sharded_backend_waits_for_item_15(rng):
    """Item 15 is done: ``lum_sharded`` runs ``parallel.sharded_lum``. In a
    process without a process group ``make_mesh`` forms a one-rank gloo group
    on the CPU, which the backend destroys before it returns; the JAX backend
    shards the edges over its 8 virtual devices."""
    import torch.distributed as dist

    P, pairs, _ = _graph(rng, 6, [(0, 5)], n_valid=140)
    kw = dict(max_iterations=4, cg_iters=64)
    j = _pose_graph(jgo, P, pairs).optimize("lum_sharded", **kw)
    assert not dist.is_initialized()
    try:
        t = _pose_graph(tgo, P, pairs).optimize("lum_sharded", device="cpu", **kw)
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    gap_t, gap_r = _gap(t, j)
    assert gap_t <= TOL_M and gap_r <= TOL_RAD
    g = tgo.PoseGraph()
    with pytest.raises(ValueError, match="unknown optimizer"):
        g.optimize("nope")


def test_register_optimizer_adds_a_backend():
    called = {}

    def identity_opt(graph, **kw):
        called["n"] = graph.n_vertices
        return graph.poses()

    tgo.register_optimizer("identity_for_test", identity_opt)
    try:
        g = tgo.PoseGraph()
        g.add_vertex()
        g.add_vertex()
        np.testing.assert_array_equal(g.optimize("identity_for_test"), np.stack([np.eye(4)] * 2))
        assert called["n"] == 2 and g.n_edges == 0
    finally:
        del tgo._REGISTRY["identity_for_test"]


def test_graph_exported_under_jax_names():
    treg = importlib.import_module("pcl_tpu_torch.registration")
    jreg = importlib.import_module("pcl_tpu.registration")
    for name in ("PoseGraphResult", "lum", "elch_distribute", "build_edges_from_correspondences"):
        assert name in treg.__all__ and name in jreg.__all__
        assert getattr(treg, name) is getattr(tg, name)
