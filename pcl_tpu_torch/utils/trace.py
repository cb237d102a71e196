"""The port's spans and counters: one recorder, kept in memory.

A span names a stretch of host code: ``with span("gicp.solve"): ...``. While
the recorder is on it opens ``torch.profiler.record_function("pcl." + name)``,
so that under ``torch.profiler`` the span lies on the profiler's timeline
beside the kernels it launched (the profiler repeats the range on the
device's timeline, over those kernels), and it appends ``(name, parent,
t0_ns, t1_ns)`` on ``time.perf_counter_ns()`` to the recorder's list, where
``parent`` is the index of the span that was open around it (-1 for none).
While the recorder is off a span is one flag test and a shared no-op
context. A span never synchronises the device.

``count(name, n)`` adds ``n`` to a counter. A Python int always counts. A 0-d
tensor counts only while the recorder is on: it is summed where it lies,
without a read-back, and :func:`snapshot` reads it once. ``readback(site)``
marks a place where the host waits for the device: a value read back, or a
copy from host memory, which waits for the device's stream to drain. It
counts ``"sync." + site`` always and is the span ``"sync." + site`` while
the recorder is on, so the host's time inside it is its wait for the device.

The recorder serves one thread; it exports nothing. A caller turns it on
(``enable()``), clears it (``reset()``) and reads it (``snapshot()``, or
``counts()`` for the host counters alone, which reads nothing back).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

_on = False
_spans: List[list] = []                 # [name, parent, t0_ns, t1_ns]
_open: List[int] = []                   # indices of the spans open now
_counts: Dict[str, int] = {}
_device_counts: Dict[str, torch.Tensor] = {}
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn the recorder on (or off with ``on=False``); what it holds stays."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span and counter."""
    _spans.clear()
    _open.clear()
    _counts.clear()
    _device_counts.clear()


class _Span:
    __slots__ = ("name", "entry", "fn")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Span":
        self.fn = torch.profiler.record_function("pcl." + self.name)
        self.fn.__enter__()
        self.entry = [self.name, _open[-1] if _open else -1, time.perf_counter_ns(), None]
        _open.append(len(_spans))
        _spans.append(self.entry)
        return self

    def __exit__(self, *exc) -> None:
        self.entry[3] = time.perf_counter_ns()
        if _open:
            _open.pop()
        self.fn.__exit__(*exc)


def span(name: str):
    """A context manager over the named stretch of host code (see above)."""
    return _Span(name) if _on else _OFF


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name``: a Python int always, a 0-d tensor only
    while the recorder is on (summed on its device until :func:`snapshot`)."""
    if isinstance(n, torch.Tensor):
        if _on:
            n = n.detach().to(torch.int64)
            acc = _device_counts.get(name)
            _device_counts[name] = n if acc is None else acc + n
        return
    _counts[name] = _counts.get(name, 0) + n


def readback(site: str):
    """Around a place where the host waits for the device: counts
    ``"sync." + site`` and, while the recorder is on, spans it."""
    name = "sync." + site
    _counts[name] = _counts.get(name, 0) + 1
    return _Span(name) if _on else _OFF


def counts() -> Dict[str, int]:
    """The host counters as they stand (no device value is read)."""
    return dict(_counts)


def snapshot() -> dict:
    """``{"spans": [(name, parent, t0_ns, t1_ns), ...], "counters": {...}}``:
    the spans in the order they opened (``t1_ns`` None while one is open) and
    every counter, the device-valued ones read back here, once each."""
    counters = dict(_counts)
    for name, t in _device_counts.items():
        counters[name] = counters.get(name, 0) + int(t)
    spans: List[Tuple[str, int, int, int]] = [tuple(e) for e in _spans]
    return {"spans": spans, "counters": counters}
