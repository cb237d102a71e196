"""SICK TiM laser scanner telegrams — CoLa-A `LMDscandata` parsing.

Equivalent of pcl::TimGrabber (reference: io/include/pcl/io/tim_grabber.h
+ io/src/tim_grabber.cpp). The live TCP socket is out of scope on compute
hosts (like the other hardware grabbers); what this module matches is the
grabber's PROTOCOL surface: ``parse_tim_packet`` is processTimPacket +
toPointClouds (tim_grabber.cpp:141-170) — split the telegram after the
26-space header, read the hex point count from the header's last token,
decode the hex mm distances, and project onto the scanner's fixed fan
(angle_start = -pi/4, range = 3pi/2, tim_grabber.h:115). ``TimGrabber``
replays recorded telegrams (one per line, or \\x02...\\x03 framed)
through the standard grabber callback interface.

Counterpart of ``pcl_tpu/io/tim.py``: the telegram parser is a copy of its
numpy code; ``TimGrabber`` places each scan on ``device`` (default CUDA).
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, make_cloud
from pcl_tpu_torch.io.grabber import Grabber

ANGLE_START = -np.pi / 4.0
ANGLE_RANGE = 2.0 * np.pi * 3.0 / 4.0


def parse_tim_packet(packet: str) -> np.ndarray:
    """[N, 3] float32 points from one `sRA LMDscandata` telegram.

    The header is everything before the 26th space; its last token is the
    hex point count; the body is that many hex distances in millimeters
    (parsePacketHeader/parsePacketBody, tim_grabber.cpp:118-137).
    Unconsumed trailing body tokens (RSSI blocks etc.) are ignored, like
    the reference's fixed-count extraction."""
    packet = packet.strip().lstrip("\x02").rstrip("\x03")
    pos = -1
    for _ in range(26):
        pos = packet.find(" ", pos + 1)
        if pos < 0:
            raise ValueError("truncated TiM telegram header")
    header, body = packet[:pos], packet[pos + 1:]
    count = int(header[header.rfind(" ") + 1:], 16)
    toks = body.split()
    if len(toks) < count:
        raise ValueError(
            f"TiM telegram body holds {len(toks)} < {count} samples")
    dist = np.array([int(t, 16) for t in toks[:count]],
                    np.float64) / 1000.0
    angle = (ANGLE_START
             + np.arange(count) * (ANGLE_RANGE / max(count, 1))
             ).astype(np.float32)
    dist = dist.astype(np.float32)
    out = np.zeros((count, 3), np.float32)
    out[:, 0] = dist * np.cos(angle)
    out[:, 1] = dist * np.sin(angle)
    return out


def load_tim_log(path: str) -> List[np.ndarray]:
    """All scans from a recorded telegram log (newline- or STX/ETX-framed)."""
    with open(path, "r") as f:
        raw = f.read()
    if "\x02" in raw:
        frames = [s for s in raw.split("\x02") if s.strip("\x03 \n")]
    else:
        frames = [ln for ln in raw.splitlines() if ln.strip()]
    return [parse_tim_packet(fr) for fr in frames]


class TimGrabber(Grabber):
    """Replay TiM telegram logs as clouds (the device-free face of
    pcl::TimGrabber — its TCP receive loop feeds the same
    processTimPacket path)."""

    def __init__(self, path: str, fps: float = 0.0, repeat: bool = False, device=None):
        super().__init__()
        self.path = path
        self.fps = fps
        self.repeat = repeat
        self.device = device

    def _produce(self):
        period = 1.0 / self.fps if self.fps > 0 else 0.0
        while True:
            for pts in load_tim_log(self.path):
                if not self._running.is_set():
                    return
                t0 = time.perf_counter()
                yield make_cloud(pts, device=self.device)
                if period:
                    time.sleep(max(0.0, period - (time.perf_counter() - t0)))
            if not self.repeat:
                return
