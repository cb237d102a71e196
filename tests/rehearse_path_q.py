"""CPU rehearsal of ``chip_smoke.py`` path Q (phase 19) at full width, to set
path Q's limits before it runs on the card.

    python tests/rehearse_path_q.py jax OUT_DIR    # the JAX package's chain
    python tests/rehearse_path_q.py port OUT_DIR   # the port's chain on the CPU

``jax`` renders path Q's inputs (``chip_smoke.path_q_inputs``) and runs
``chip_smoke.path_q_chain`` on ``JaxQ``, the JAX package's calls behind the
methods of the port's ``PortQ``, then prints ``chip_smoke.path_q_metrics``
and each function's seconds as JSON lines (each stage's start on stderr).
``port`` runs the port's chain on the CPU (its plain k-NN and 1-NN emulate
float64 products: the front end alone takes hours there). Not a test:
pytest does not collect it.
``tests/test_torch_path_q.py`` runs both chains at ``chip_smoke.Q_SMALL``.
"""

import contextlib
import io as pyio
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# above this many pairs the map's surface error takes scipy's k-d tree (float64,
# the same nearest distances) instead of XLA's CPU 1-NN, hours at full width
KDTREE_PAIRS = 1e10


class JaxQ:
    """Path Q's calls on the JAX package: the methods of
    ``chip_smoke.PortQ``, on the CPU. In the front end each sweep is padded
    to one capacity (a multiple of 4,096 rows) and each sweep's voxels to
    another (a multiple of 1,024), so that each JAX function compiles once
    and its k-NN and ICP run on the live voxels, not on the sweep's rows."""

    def __init__(self):
        from pcl_tpu import visualization
        from pcl_tpu.io import (buffers, compression, organized_compression, range_coder,
                                velodyne)

        self.vis, self.velodyne, self.buffers = visualization, velodyne, buffers
        self.compression, self.range_coder = compression, range_coder
        self.organized = organized_compression

    @staticmethod
    def _j(a):
        import jax.numpy as jnp

        return jnp.asarray(np.asarray(a))

    def cloud(self, xyz, attrs=None):
        from pcl_tpu.core.cloud import from_numpy

        return from_numpy(np.asarray(xyz, np.float32), attrs)

    @staticmethod
    def rows(c):
        m = np.asarray(c.mask)
        inten = c.attrs.get("intensity")
        return (np.asarray(c.xyz)[m], None if inten is None else np.asarray(inten)[m], "cpu")

    def grab(self, pcap, model, how):
        from pcl_tpu.io.grabber import CloudIterator

        g = self.velodyne.PcapVelodyneGrabber(pcap, model=model)
        if how == "frames":
            return list(g.frames())
        out = list(CloudIterator(g))
        g.stop()
        return out

    def front_end(self, sweeps):
        """Path C's front end on the JAX package: voxel_downsample, estimate_normals
        and point-to-plane odometry_sequence with ``chip_smoke.ICP_KW``."""
        from pcl_tpu import features, filters
        from pcl_tpu.registration import trajectory
        from pcl_tpu.registration.icp import icp

        from pcl_tpu.core.cloud import from_numpy

        cap = -(-max(c.capacity for c in sweeps) // 4096) * 4096
        vox = [self.rows(filters.voxel_downsample(c.pad_to(cap), cs.LEAF))[0] for c in sweeps]
        vcap = -(-max(len(v) for v in vox) // 1024) * 1024
        clouds = [features.estimate_normals(from_numpy(v, capacity=vcap), k=cs.NORMAL_K)
                  for v in vox]
        results = []

        def register(s, t):
            r = icp(s, t, **cs.ICP_KW)
            results.append(r)
            return r

        poses = trajectory.odometry_sequence(clouds, register=register)
        return ([self.rows(c)[0] for c in clouds], poses,
                [int(r.iterations) for r in results], [bool(r.converged) for r in results],
                [bool(r.truncated) for r in results])

    def voxel(self, xyz, leaf):
        from pcl_tpu import filters

        return self.rows(filters.voxel_downsample(self.cloud(xyz), leaf))[0]

    def nn1(self, queries, targets):
        import jax.numpy as jnp

        from pcl_tpu.search import bruteforce

        if float(len(queries)) * len(targets) > KDTREE_PAIRS:
            from scipy.spatial import cKDTree

            d, idx = cKDTree(np.asarray(targets, np.float64)).query(
                np.asarray(queries, np.float64), workers=-1)
            return idx.astype(np.int32), (d * d).astype(np.float32)
        idx, d2 = bruteforce.nn1(self._j(targets), jnp.ones(len(targets), bool),
                                 self._j(queries))
        return np.asarray(idx), np.asarray(d2)

    def store(self, root, **kw):
        from pcl_tpu.outofcore import OutofcoreOctree

        return OutofcoreOctree.create(root, **kw)

    def tree(self, root, bb_min, bb_max, max_depth):
        from pcl_tpu.outofcore import HierarchicalOutofcoreOctree

        return HierarchicalOutofcoreOctree.create(root, bb_min, bb_max, max_depth=max_depth)

    def decompress(self, blob):
        return np.asarray(self.compression.decompress_cloud(blob).xyz)

    def voxel_centres(self, sweep, res):
        import jax.numpy as jnp

        xyz = self.rows(sweep)[0]
        origin = xyz.min(0)
        cells = np.unique(np.asarray(jnp.floor((jnp.asarray(xyz) - origin) / res)).astype(
            np.int64), axis=0)
        return ((cells + 0.5) * float(np.float32(res)) + origin.astype(np.float64)).astype(
            np.float32)

    def save_cloud(self, path, sweep, data="binary_compressed"):
        from pcl_tpu.io import pcd

        pcd.save(path, sweep, data=data)

    def load_rows(self, path):
        from pcl_tpu import io

        return self.rows(io.load(path))

    def image_grabber(self, folder, focal):
        from pcl_tpu.io.grabber import ImageGrabber

        return [(np.asarray(c.xyz), np.asarray(c.mask), c.width, c.height, "cpu")
                for c in ImageGrabber(folder, focal).frames()]

    def tim_frames(self, log):
        from pcl_tpu.io.tim import TimGrabber

        got = []
        g = TimGrabber(log)
        g.register_callback(got.append)
        g.start()
        t0 = time.perf_counter()
        while g.is_running() and time.perf_counter() - t0 < 60.0:
            time.sleep(0.005)
        thread = g._thread
        g.stop()
        return ([self.rows(c)[0] for c in got], ["cpu"] * len(got),
                thread is not None and not thread.is_alive())

    def organized_mesh(self, xyz_img, valid):
        from pcl_tpu import surface
        from pcl_tpu.core.cloud import make_cloud

        H, W = valid.shape
        v, t = surface.organized_fast_mesh(make_cloud(self._j(xyz_img.reshape(-1, 3)),
                                                      self._j(valid.reshape(-1)),
                                                      width=W, height=H))
        return np.asarray(v, np.float32), np.asarray(t)

    def range_image(self, sweep):
        from pcl_tpu.core import range_image

        pose = self._j(np.array([[-1.0, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                                np.float32))
        return np.asarray(range_image.create_from_cloud(sweep, sensor_pose=pose).ranges)

    def tool(self, name, argv):
        """The JAX package's CLI. Its hdl_grabber_example has no ``-save``: the
        sweeps it would save are its pcap_to_pcd's, which write them instead."""
        import importlib

        argv = list(argv)
        if name == "hdl_grabber_example" and "-save" in argv:
            i = argv.index("-save")
            prefix = argv[i + 1]
            del argv[i:i + 2]
            model = argv[argv.index("-model") + 1]
            self.tool("pcap_to_pcd", [argv[0], prefix, "-model", model])
        with contextlib.redirect_stdout(pyio.StringIO()) as out:
            rc = importlib.import_module(f"pcl_tpu.tools.{name}").main(argv)
        return rc, out.getvalue()


def jax_chain(inp, Q, poses=None, on_stage=None):
    """``chip_smoke.path_q_chain`` on the JAX package (on the CPU)."""
    return cs.path_q_chain(inp, Q, "cpu", lib=JaxQ(), poses=poses, on_stage=on_stage)


def _progress():
    """An ``on_stage`` that prints each new stage and the time to stderr."""
    last = [None]
    t0 = time.perf_counter()

    def on_stage(name):
        if name != last[0]:
            last[0] = name
            print(f"{time.perf_counter() - t0:9.1f} s  {name}", file=sys.stderr, flush=True)

    return on_stage


def main(argv):
    mode, out_dir = argv[1], argv[2]
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        t0 = time.perf_counter()
        inp = cs.path_q_inputs(cs.Q_FULL, tmp)
        print(json.dumps({"inputs_s": time.perf_counter() - t0}), flush=True)
        if mode == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            out, secs = jax_chain(inp, cs.Q_FULL, on_stage=_progress())
        elif mode == "port":
            out, secs = cs.path_q_chain(inp, cs.Q_FULL, "cpu", on_stage=_progress())
        else:
            raise SystemExit(f"unknown mode {mode!r}: jax or port")
        m = cs.path_q_metrics(inp, out, cs.Q_FULL)
    print(json.dumps({"mode": mode, "metrics": m}, default=float), flush=True)
    print(json.dumps({"mode": mode, "seconds": secs}), flush=True)
    with open(os.path.join(out_dir, f"path_q_{mode}.json"), "w") as f:
        json.dump({"metrics": m, "seconds": secs}, f, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
