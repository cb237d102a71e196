"""Console and CLI helpers: argument parsing, triggers, small math fits.

Counterpart of ``pcl_tpu/utils/console.py``, copied (numpy and threads on
the host):

- parse helpers (reference console/parse.h): ``parse_argument``,
  ``parse_x_arguments``, ``find_switch``, ``parse_file_extension_argument``;
- ``TimeTrigger`` (common/time_trigger.h:55): a callback at a fixed
  interval on a worker thread;
- ``Synchronizer`` (common/synchronizer.h:55): pairs the items of two
  timestamped streams and hands each pair to the callbacks;
- ``gaussian_kernel_1d``, ``fit_polynomial``, ``eval_polynomial``
  (common/gaussian.h, polynomial_calculations.h).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------------- parse

def find_switch(argv: Sequence[str], name: str) -> bool:
    return name in argv


def parse_argument(argv: Sequence[str], name: str, cast=str):
    """Value following ``name``, or None (parse.h parse_argument)."""
    for i, a in enumerate(argv):
        if a == name and i + 1 < len(argv):
            return cast(argv[i + 1])
    return None


def parse_x_arguments(argv: Sequence[str], name: str, n: int, cast=float):
    """N comma-separated values after ``name`` (parse_2x/3x_arguments)."""
    v = parse_argument(argv, name)
    if v is None:
        return None
    parts = v.split(",")
    if len(parts) != n:
        raise ValueError(f"{name} expects {n} comma-separated values")
    return [cast(p) for p in parts]


def parse_file_extension_argument(argv: Sequence[str], ext: str) -> List[int]:
    """Indices of positional args with the given extension."""
    e = ext.lower().lstrip(".")
    return [
        i for i, a in enumerate(argv) if a.lower().endswith("." + e)
    ]


# ----------------------------------------------------------------- timing

class TimeTrigger:
    """Fixed-interval callback dispatcher (time_trigger.h:55:
    registerCallback + start/stop)."""

    def __init__(self, interval: float, callback: Optional[Callable] = None):
        self.interval = interval
        self._callbacks: List[Callable] = [callback] if callback else []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register_callback(self, cb: Callable) -> None:
        self._callbacks.append(cb)

    def set_interval(self, interval: float) -> None:
        self.interval = interval

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval):
                for cb in self._callbacks:
                    cb()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class Synchronizer:
    """Pair up two timestamped streams; whenever both sides have data the
    newest pair is delivered to every registered callback
    (synchronizer.h add0/add1/publish)."""

    def __init__(self):
        self._q0: List[Tuple[float, object]] = []
        self._q1: List[Tuple[float, object]] = []
        self._callbacks: List[Callable] = []
        self._lock = threading.Lock()

    def register_callback(self, cb: Callable) -> None:
        self._callbacks.append(cb)

    def add0(self, item, stamp: Optional[float] = None) -> None:
        self._add(self._q0, item, stamp)

    def add1(self, item, stamp: Optional[float] = None) -> None:
        self._add(self._q1, item, stamp)

    def _add(self, q, item, stamp):
        with self._lock:
            q.append((time.monotonic() if stamp is None else stamp, item))
            self._publish()

    def _publish(self):
        while self._q0 and self._q1:
            t0, i0 = self._q0[0]
            t1, i1 = self._q1[0]
            self._q0.pop(0)
            self._q1.pop(0)
            for cb in self._callbacks:
                cb(i0, i1, t0, t1)


# ----------------------------------------------------------------- math

def gaussian_kernel_1d(sigma: float, size: Optional[int] = None,
                       derivative: bool = False) -> np.ndarray:
    """Sampled, normalized 1D Gaussian (or its derivative)
    (gaussian.h GaussianKernel::compute)."""
    if size is None:
        size = int(2 * round(3 * sigma) + 1)
    r = size // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2 * sigma * sigma))
    g /= g.sum()
    if derivative:
        d = -x / (sigma * sigma) * g
        d -= d.mean()
        return d
    return g


def fit_polynomial(x: np.ndarray, y: np.ndarray, order: int,
                   weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Weighted least-squares polynomial coefficients (lowest order first)
    (polynomial_calculations.h bivariatePolynomialApproximation, 1D case)."""
    x = np.asarray(x, np.float64)
    A = np.stack([x**k for k in range(order + 1)], 1)
    w = np.ones_like(x) if weights is None else np.asarray(weights, np.float64)
    Aw = A * w[:, None]
    coef, *_ = np.linalg.lstsq(Aw, np.asarray(y) * w, rcond=None)
    return coef


def eval_polynomial(coef: np.ndarray, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return sum(c * x**k for k, c in enumerate(coef))
