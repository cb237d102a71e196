"""One rank of the port's sharded functions on the CPU under gloo.

    python tests/torch_parallel_worker.py STORE INPUTS.npz OUT_DIR

with ``PCL_TPU_NPROCS`` and ``PCL_TPU_PROC_ID`` set: the rank joins the group
through ``runtime.initialize_multihost`` over the ``file://`` store STORE,
runs every case of ``tests/test_torch_parallel.py`` on the inputs that file
wrote, and saves its outputs to ``OUT_DIR/rank<id>.npz``. Imports no JAX.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pcl_tpu_torch.parallel import runtime  # noqa: E402  (before any group)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(d, name):
    src, dst = _t(d[f"{name}/src"]), _t(d[f"{name}/dst"])
    return src, torch.ones(len(src), dtype=torch.bool), dst, torch.ones(len(dst), dtype=torch.bool)


def _registration(mesh, d, out):
    from pcl_tpu_torch.parallel.gicp_sharded import sharded_gicp
    from pcl_tpu_torch.parallel.icp_sharded import sharded_icp
    from pcl_tpu_torch.parallel.ndt_sharded import sharded_ndt

    mesh.counts.clear()
    T, mse, it = sharded_icp(mesh, *_pair(d, "icp"), max_iterations=25)
    out.update({"icp/T": _np(T), "icp/mse": _np(mse), "icp/it": _np(it)})
    out.update({f"icp/counts/{k}": np.asarray(v) for k, v in mesh.counts.items()})
    from pcl_tpu_torch.parallel.icp_sharded import sharded_icp_step
    step = sharded_icp_step(mesh)
    src, sm, tgt, tm = _pair(d, "icp")
    T1, mse1 = step(src, sm, tgt, tm, torch.zeros_like(tgt), torch.eye(4), float("inf"))
    out.update({"icp/step_T": _np(T1), "icp/step_mse": _np(mse1)})
    T, _, _ = sharded_icp(mesh, *_pair(d, "p2pl"), tgt_normals=_t(d["p2pl/normals"]),
                          max_iterations=15, variant="point_to_plane")
    out["p2pl/T"] = _np(T)
    T, mse, _ = sharded_gicp(mesh, *_pair(d, "gicp"), max_corr_dist=0.5, max_iterations=20,
                             k_covariances=12)
    out.update({"gicp/T": _np(T), "gicp/mse": _np(mse)})
    T, _, _ = sharded_icp(mesh, *_pair(d, "blocked"), max_corr_dist=0.05, max_iterations=5,
                          corr_backend="cell_blocked", cell_cap=12, grid_dims=(64, 64, 64))
    out["blocked/T"] = _np(T)
    mesh.counts.clear()
    T, score, it = sharded_ndt(mesh, *_pair(d, "ndt"), resolution=1.5, max_iterations=30,
                               step_size=0.5, table_size=1 << 14, min_points=4)
    out.update({"ndt/T": _np(T), "ndt/score": _np(score), "ndt/it": _np(it)})
    out.update({f"ndt/counts/{k}": np.asarray(v) for k, v in mesh.counts.items()})
    for backend, kw in (("brute", {}), ("cell", dict(cell_cap=32))):
        T, _, _ = sharded_icp(mesh, *_pair(d, "cellpair"), max_iterations=20,
                              max_corr_dist=0.12, corr_backend=backend, **kw)
        out[f"cellpair/{backend}/T"] = _np(T)


def _lum(mesh, d, out):
    from pcl_tpu_torch.parallel.graph_sharded import sharded_lum

    mesh.counts.clear()
    r = sharded_lum(mesh, _t(d["lum/init"]), *(_t(d[f"lum/{k}"]) for k in
                                              ("es", "ed", "cs", "cd", "cv")),
                    max_iterations=6, cg_iters=64)
    out.update({"lum/poses": _np(r.poses), "lum/residual": _np(r.residual)})
    out.update({f"lum/counts/{k}": np.asarray(v) for k, v in mesh.counts.items()})


def _tsdf(mesh, d, out, tmp):
    from pcl_tpu_torch.fusion.tsdf import Intrinsics, make_volume
    from pcl_tpu_torch.fusion.world_model import WorldModel, save_tsdf
    from pcl_tpu_torch.parallel.mesh import gather_shards
    from pcl_tpu_torch.parallel.tsdf_sharded import (
        integrate_sharded,
        raycast_sharded,
        shift_sharded,
    )

    H, W = 24, 32
    intr = Intrinsics(fx=32.0, fy=32.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    vol = make_volume(64, 3.2, origin=(-1.6, -1.6, 0.0), device="cpu")
    vol = integrate_sharded(mesh, vol, _t(d["tsdf/depth"]), intr, torch.eye(4))
    out["tsdf/slab"] = np.asarray(vol.tsdf.shape)
    out["tsdf/tsdf"] = _np(gather_shards(mesh, vol.tsdf))
    out["tsdf/weight"] = _np(gather_shards(mesh, vol.weight))
    verts, nrm, hit = raycast_sharded(mesh, vol, intr, torch.eye(4), H, W,
                                      near=0.2, far=2.5, n_steps=128)
    out.update({"tsdf/verts": _np(verts), "tsdf/normals": _np(nrm), "tsdf/hit": _np(hit)})
    vol2, ev_t, ev_w, ev_origin = shift_sharded(mesh, vol)
    out.update({"shift/tsdf": _np(gather_shards(mesh, vol2.tsdf)),
                "shift/weight": _np(gather_shards(mesh, vol2.weight)),
                "shift/origin": _np(vol2.origin), "shift/ev_t": _np(ev_t),
                "shift/ev_w": _np(ev_w), "shift/ev_origin": _np(ev_origin)})
    wm = WorldModel(float(vol.voxel_size), world_origin=_np(vol.origin))
    wm.push_slab(float(ev_origin[0]), ev_t, ev_w)
    t_back, w_back = wm.fetch_slab(float(ev_origin[0]), tuple(ev_t.shape))
    out.update({"world/t": t_back, "world/w": w_back})
    if dist.get_rank() == 0:
        save_tsdf(os.path.join(tmp, "port_vol.npz"), dataclasses.replace(
            vol, tsdf=_t(out["tsdf/tsdf"]), weight=_t(out["tsdf/weight"])))


def _hybrid(d, out):
    from pcl_tpu_torch.parallel.icp_sharded import sharded_icp

    mesh = runtime.hybrid_mesh(dcn_size=2, device="cpu")
    out["hybrid/info"] = np.asarray([mesh.shape["dcn"], mesh.shape["ici"]])
    try:
        runtime.hybrid_mesh(dcn_size=3, device="cpu")
        out["hybrid/raises"] = np.asarray(False)
    except ValueError:
        out["hybrid/raises"] = np.asarray(True)
    T, _, _ = sharded_icp(mesh, *_pair(d, "hybrid"), max_iterations=25, axis=("dcn", "ici"))
    out["hybrid/T"] = _np(T)
    # the single axes reduce over their own groups
    from pcl_tpu_torch.parallel.mesh import _all_gather, _psum
    me = torch.tensor([float(dist.get_rank())])
    out["hybrid/ici_sum"] = _np(_psum(mesh, me, "ici"))
    out["hybrid/dcn_gather"] = _np(_all_gather(mesh, me, "dcn"))


def _dryrun(mesh, d, out):
    """``__graft_entry__.dryrun_multichip``'s sequence at its shapes (n
    devices = the world size)."""
    from pcl_tpu_torch.fusion.tsdf import Intrinsics, make_volume
    from pcl_tpu_torch.parallel.gicp_sharded import sharded_gicp
    from pcl_tpu_torch.parallel.graph_sharded import sharded_lum
    from pcl_tpu_torch.parallel.icp_sharded import sharded_icp
    from pcl_tpu_torch.parallel.mesh import gather_shards
    from pcl_tpu_torch.parallel.ndt_sharded import sharded_ndt
    from pcl_tpu_torch.parallel.tsdf_sharded import (
        integrate_sharded,
        raycast_sharded,
        shift_sharded,
    )

    n_dev = dist.get_world_size()
    pair = _pair(d, f"dry{n_dev}")
    out["dry/icp"] = _np(sharded_icp(mesh, *pair, max_corr_dist=0.5, max_iterations=3)[0])
    nrm = torch.tensor([0.0, 0.0, 1.0]).repeat(len(pair[2]), 1)
    out["dry/p2pl"] = _np(sharded_icp(mesh, *pair, tgt_normals=nrm, max_corr_dist=0.5,
                                      max_iterations=2, variant="point_to_plane")[0])
    res = 8 * n_dev
    vol = make_volume(res, 2.0, origin=(-1.0, -1.0, 0.0), device="cpu")
    intr = Intrinsics(fx=32.0, fy=32.0, cx=16.0, cy=12.0)
    vol2 = integrate_sharded(mesh, vol, torch.full((24, 32), 1.0), intr, torch.eye(4))
    out["dry/tsdf"] = _np(gather_shards(mesh, vol2.tsdf))
    verts, _, hit = raycast_sharded(mesh, vol2, intr, torch.eye(4), 24, 32, far=2.0,
                                    n_steps=64)
    out.update({"dry/verts": _np(verts), "dry/hit": _np(hit)})
    vol3, ev_t, _, ev_origin = shift_sharded(mesh, vol2)
    out.update({"dry/ev_t": _np(ev_t), "dry/origin3": _np(vol3.origin)})
    out["dry/gicp"] = _np(sharded_gicp(mesh, *pair, max_corr_dist=0.5, max_iterations=2,
                                       k_covariances=8)[0])
    r = sharded_lum(mesh, _t(d["dry/init"]), *(_t(d[f"dry/{k}"]) for k in
                                              ("es", "ed", "cs", "cd", "cv")),
                    max_iterations=2, cg_iters=16)
    out.update({"dry/lum": _np(r.poses), "dry/lum_res": _np(r.residual)})
    out["dry/ndt"] = _np(sharded_ndt(mesh, *pair, resolution=0.5, max_iterations=3,
                                     table_size=1 << 12, min_points=3)[0])
    out["dry/blocked"] = _np(sharded_icp(mesh, *_pair(d, f"dryb{n_dev}"), max_corr_dist=0.05,
                                         max_iterations=2, corr_backend="cell_blocked",
                                         cell_cap=12, grid_dims=(64, 64, 64))[0])


def main(store: str, inputs: str, out_dir: str) -> int:
    torch.set_num_threads(1)
    assert runtime.initialize_multihost(init_method=f"file://{store}", device="cpu")
    from pcl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    d = dict(np.load(inputs))
    out = {"world": np.asarray(dist.get_world_size()), "backend": np.asarray(mesh.backend)}
    _registration(mesh, d, out)
    _lum(mesh, d, out)
    _tsdf(mesh, d, out, out_dir)
    if dist.get_world_size() == 4:
        _dryrun(mesh, d, out)
        _hybrid(d, out)
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
