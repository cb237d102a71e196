"""Grabber framework — streaming cloud sources with callbacks.

Counterpart of ``pcl_tpu/io/grabber.py`` (reference: io/include/pcl/io/
grabber.h:59-165 — start/stop/registerCallback over boost::signals2, with
device grabbers and file-replay grabbers built on it):

- ``Grabber``: register_callback / start / stop / is_running and a
  background thread pumping frames (the reference's capture thread);
- ``PCDGrabber``: replays a list of PCD/PLY files at a target FPS
  (reference: pcd_grabber.h), optionally looping;
- ``ImageGrabber``: replays depth images (.npy, float metres) as organized
  clouds through a pinhole model (reference: image_grabber.h), the vertex
  map computed on the device;
- ``CloudIterator``: pull-based iteration over any grabber.

Every grabber that makes clouds takes ``device`` (default CUDA). As in the
JAX package, an exception raised by a callback ends the pump thread and is
only printed by ``threading``: a caller that must see every frame counts
them.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

from pcl_tpu_torch.core.cloud import Cloud


class Grabber:
    """Callback pump. Subclasses implement _produce() yielding frames."""

    def __init__(self):
        self._callbacks: List[Callable[[Cloud], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()

    def register_callback(self, cb: Callable[[Cloud], None]) -> Callable[[], None]:
        """Returns an unregister function (the reference returns a
        signals2 connection)."""
        self._callbacks.append(cb)
        return lambda: self._callbacks.remove(cb)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._running.set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def is_running(self) -> bool:
        return self._running.is_set()

    def frames(self):
        """Synchronous pull-mode iterator over the grabber's frames — the
        trigger-mode counterpart of the callback pump."""
        self._running.set()
        try:
            yield from self._produce()
        finally:
            self._running.clear()

    # -- to implement ----------------------------------------------------
    def _produce(self):
        raise NotImplementedError

    def _run(self):
        for frame in self._produce():
            if not self._running.is_set():
                break
            for cb in list(self._callbacks):
                cb(frame)
        self._running.clear()


class PCDGrabber(Grabber):
    """Replay PCD/PLY files (reference: pcd_grabber.h)."""

    def __init__(self, paths: Sequence[str] | str, fps: float = 0.0,
                 repeat: bool = False, device=None):
        super().__init__()
        if isinstance(paths, str):
            if os.path.isdir(paths):
                paths = sorted(
                    glob.glob(os.path.join(paths, "*.pcd"))
                    + glob.glob(os.path.join(paths, "*.ply"))
                )
            else:
                paths = [paths]
        self.paths = list(paths)
        self.fps = fps
        self.repeat = repeat
        self.device = device

    def _produce(self):
        from pcl_tpu_torch import io
        period = 1.0 / self.fps if self.fps > 0 else 0.0
        while True:
            for p in self.paths:
                if not self._running.is_set():
                    return
                t0 = time.perf_counter()
                yield io.load(p, device=self.device)
                if period:
                    time.sleep(max(0.0, period - (time.perf_counter() - t0)))
            if not self.repeat:
                return


class ImageGrabber(Grabber):
    """Replay depth images (.npy float meters) as organized clouds
    (reference: image_grabber.h)."""

    def __init__(self, paths: Sequence[str] | str, focal: float,
                 fps: float = 0.0, repeat: bool = False, device=None):
        super().__init__()
        if isinstance(paths, str):
            paths = sorted(glob.glob(os.path.join(paths, "*.npy")))
        self.paths = list(paths)
        self.focal = focal
        self.fps = fps
        self.repeat = repeat
        self.device = device

    def _produce(self):
        import numpy as np
        import torch

        from pcl_tpu_torch.core.cloud import _device, make_cloud
        from pcl_tpu_torch.fusion import Intrinsics, depth_to_vertex_map
        dev = _device(self.device)
        period = 1.0 / self.fps if self.fps > 0 else 0.0
        while True:
            for p in self.paths:
                if not self._running.is_set():
                    return
                t0 = time.perf_counter()
                depth = torch.as_tensor(np.load(p).astype(np.float32), device=dev)
                H, W = depth.shape
                intr = Intrinsics(self.focal, self.focal, W / 2.0, H / 2.0)
                vm = depth_to_vertex_map(depth, intr)
                mask = (depth > 0).reshape(-1)
                yield make_cloud(vm.reshape(-1, 3), mask, width=W, height=H, device=dev)
                if period:
                    time.sleep(max(0.0, period - (time.perf_counter() - t0)))
            if not self.repeat:
                return


class CloudIterator:
    """Pull interface over a grabber (bounded queue, backpressure)."""

    def __init__(self, grabber: Grabber, maxsize: int = 4):
        self.grabber = grabber
        self.q: "queue.Queue[Optional[Cloud]]" = queue.Queue(maxsize=maxsize)
        grabber.register_callback(self.q.put)

    def __iter__(self):
        self.grabber.start()
        while True:
            try:
                item = self.q.get(timeout=0.5)
                yield item
            except queue.Empty:
                if not self.grabber.is_running():
                    return
