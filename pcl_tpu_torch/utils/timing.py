"""Wall-clock timing utilities.

Counterpart of ``pcl_tpu/utils/timing.py``: ``StopWatch``, the ``ScopeTime``
context manager and the ``EventFrequency`` meter are host clocks; a caller
that times device work synchronises first (``torch.cuda.synchronize()``).
The JAX package's ``time_jitted`` has no counterpart: the port's spans and
counters are ``utils/trace.py``'s.
"""

from __future__ import annotations

import time
from typing import Optional


class StopWatch:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    def ms(self) -> float:
        return self.seconds() * 1e3


class ScopeTime:
    """Context manager printing elapsed wall time on exit."""

    def __init__(self, title: str = "", printer=print) -> None:
        self.title = title
        self.printer = printer
        self.elapsed_ms: Optional[float] = None

    def __enter__(self) -> "ScopeTime":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        if self.printer is not None:
            self.printer(f"[ScopeTime] {self.title}: {self.elapsed_ms:.3f} ms")


class EventFrequency:
    """Sliding-window events/second meter."""

    def __init__(self, window: int = 30) -> None:
        self.window = window
        self._stamps: list = []

    def event(self) -> None:
        self._stamps.append(time.perf_counter())
        if len(self._stamps) > self.window:
            self._stamps.pop(0)

    def frequency(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0

