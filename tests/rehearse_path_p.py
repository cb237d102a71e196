"""CPU rehearsal of ``chip_smoke.py`` path P (phase 18) at full width, to set
path P's limits before it runs on the card.

    python tests/rehearse_path_p.py jax OUT_DIR    # the JAX package's chain
    python tests/rehearse_path_p.py port OUT_DIR   # the port's chain on the CPU

``jax`` renders path P's inputs (``chip_smoke.path_p_inputs``) and runs
``chip_smoke.path_p_chain`` on ``JaxP``, the JAX package's calls with the
port's ``PortP`` methods, then prints ``chip_smoke.path_p_metrics`` and each
function's seconds as JSON lines. ``port`` runs the port's chain on the
CPU (B1's plain version emulates float64 products: (b)'s ICP takes tens of
minutes there). Not a test: pytest does not collect it.
``tests/test_torch_path_p.py`` runs both chains at 80 x 60.
"""

import contextlib
import io as pyio
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


class JaxP:
    """Path P's calls on the JAX package: numpy in, numpy out, the methods
    of ``chip_smoke.PortP``."""

    def __init__(self):
        import pcl_tpu.geometry as geometry
        from pcl_tpu.io import formats_extra, png, tiff

        self.geometry, self.png, self.tiff, self.formats = geometry, png, tiff, formats_extra

    @staticmethod
    def _j(a):
        import jax.numpy as jnp

        return jnp.asarray(np.asarray(a))

    def block_matching(self, left, right, D):
        from pcl_tpu import stereo

        return np.asarray(stereo.block_matching(self._j(left), self._j(right), max_disparity=D))

    def adaptive(self, left, right, D):
        from pcl_tpu import stereo

        return np.asarray(stereo.adaptive_cost_so_matching(self._j(left), self._j(right),
                                                           max_disparity=D))

    def disparity_to_cloud(self, disp, f, b, u0, v0):
        from pcl_tpu import stereo

        c = stereo.disparity_to_cloud(self._j(disp), f, b, u0, v0)
        return np.asarray(c.xyz), np.asarray(c.mask)

    def dem(self, disp, grey, f, b, cx, cy):
        from pcl_tpu import stereo

        h, n = stereo.disparity_to_dem(self._j(disp), self._j(grey), f, b, cx, cy)
        return np.asarray(h), np.asarray(n)

    def voxel(self, xyz, leaf):
        from pcl_tpu.core.cloud import make_cloud
        from pcl_tpu.filters import voxel_downsample

        v = voxel_downsample(make_cloud(self._j(xyz)), leaf)
        return np.asarray(v.xyz)[np.asarray(v.mask)]

    def icp(self, src, tgt, **kw):
        from pcl_tpu.core.cloud import make_cloud
        from pcl_tpu.registration.icp import icp

        r = icp(make_cloud(self._j(src)), make_cloud(self._j(tgt)), corr_backend="brute", **kw)
        return np.asarray(r.transform), bool(r.converged), int(r.iterations)

    def normals(self, xyz, valid):
        from pcl_tpu.features import integral_image_normals

        n, c = integral_image_normals(self._j(xyz), self._j(valid), mode="gradient")
        return np.asarray(n), np.asarray(c)

    def organized(self, xyz, valid, attrs):
        from pcl_tpu.core.cloud import make_cloud

        H, W = valid.shape
        return make_cloud(self._j(xyz.reshape(-1, 3)), self._j(valid.reshape(-1)),
                          {k: self._j(a.reshape((H * W,) + a.shape[2:])) for k, a in attrs.items()},
                          width=W, height=H)

    def edges(self, cloud):
        from pcl_tpu.features import organized_edge as edge

        labels = np.asarray(edge.organized_edge_detection(cloud, edge_types=31))
        return labels, edge.edge_label_indices(labels)

    def extract(self, name, cloud, **kw):
        from pcl_tpu import image

        return getattr(image, name)(cloud, **kw)

    def save_cloud(self, path, cloud):
        from pcl_tpu import io

        io.save(path, cloud)

    def tool(self, name, argv):
        import importlib

        with contextlib.redirect_stdout(pyio.StringIO()):
            return importlib.import_module(f"pcl_tpu.tools.{name}").main(list(argv))

    def load_cloud(self, path):
        from pcl_tpu import io

        c = io.load(path)
        return np.asarray(c.xyz), np.asarray(c.mask)

    def model(self, xyz):
        from pcl_tpu.core.cloud import make_cloud

        return make_cloud(self._j(xyz))

    def render(self, model, pose, intr, H, W):
        from pcl_tpu import simulation
        from pcl_tpu.fusion.tsdf import Intrinsics

        return simulation.render_depth(model, self._j(pose.astype(np.float32)),
                                       Intrinsics(*intr), H, W)

    def likelihood(self, rendered, observed):
        from pcl_tpu import simulation

        return float(simulation.range_likelihood(rendered, self._j(observed)))

    def fast_mesh(self, cloud):
        from pcl_tpu import surface

        return surface.organized_fast_mesh(cloud)

    def save_mesh_ply(self, path, verts, tris):
        from pcl_tpu.core.cloud import make_cloud
        from pcl_tpu.io import ply

        ply.save(path, make_cloud(self._j(verts)), faces=tris)

    def nn1(self, queries, targets):
        import jax.numpy as jnp

        from pcl_tpu.search import bruteforce

        t = self._j(targets)
        idx, d2 = bruteforce.nn1(t, jnp.ones(len(targets), bool), self._j(queries))
        return np.asarray(idx), np.asarray(d2)


def jax_chain(inp, P, normals=None):
    """``chip_smoke.path_p_chain`` on the JAX package (on the CPU)."""
    return cs.path_p_chain(inp, P, "cpu", lib=JaxP(), normals=normals)


def main(argv):
    mode, out_dir = argv[1], argv[2]
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    inp = cs.path_p_inputs(cs.P_FULL)
    print(json.dumps({"inputs_s": time.perf_counter() - t0}), flush=True)
    if mode == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        out, secs = jax_chain(inp, cs.P_FULL)
    elif mode == "port":
        out, secs = cs.path_p_chain(inp, cs.P_FULL, "cpu")
    else:
        raise SystemExit(f"unknown mode {mode!r}: jax or port")
    m = cs.path_p_metrics(inp, out, cs.P_FULL)
    print(json.dumps({"mode": mode, "metrics": m}, default=float), flush=True)
    print(json.dumps({"mode": mode, "seconds": secs}), flush=True)
    with open(os.path.join(out_dir, f"path_p_{mode}.json"), "w") as f:
        json.dump({"metrics": m, "seconds": secs}, f, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
