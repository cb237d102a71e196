"""Adaptive order-0 byte range coder.

Capability match for the reference's entropy range coder
(io/include/pcl/io/impl/entropy_range_coder.hpp — used as the entropy
backend of octree point-cloud compression). Carry-less 32-bit range coder
with an adaptive frequency table, operating on byte streams.

Counterpart of ``pcl_tpu/io/range_coder.py``: a copy of its pure-Python
32-bit arithmetic, so that streams are the JAX package's byte for byte.
"""

from __future__ import annotations

import numpy as np

_TOP = 1 << 24
_BOT = 1 << 16


class _Freq:
    def __init__(self):
        self.freq = np.ones(257, np.uint32)  # 256 symbols + cumulative scratch
        self.cum = np.arange(257, dtype=np.uint32)
        self.total = 256
        self._dirty = False

    def cumfreq(self, s: int) -> int:
        if self._dirty:
            self.cum = np.concatenate(
                [[0], np.cumsum(self.freq[:256], dtype=np.uint64)]
            ).astype(np.uint32)
            self._dirty = False
        return int(self.cum[s])

    def update(self, s: int) -> None:
        self.freq[s] += 32
        self.total += 32
        self._dirty = True
        if self.total >= _BOT:
            self.freq[:256] = (self.freq[:256] >> 1) | 1
            self.total = int(self.freq[:256].sum())

    def find(self, value: int) -> int:
        if self._dirty:
            self.cumfreq(0)
        return int(np.searchsorted(self.cum[1:257], value, side="right"))


def encode(data: bytes) -> bytes:
    f = _Freq()
    low = 0
    rng = 0xFFFFFFFF
    out = bytearray()
    for byte in data:
        rng //= f.total
        low += f.cumfreq(byte) * rng
        rng *= int(f.freq[byte])
        low &= 0xFFFFFFFFFFFF  # keep carries visible (48-bit window)
        while True:
            if (low ^ (low + rng)) < _TOP:
                pass
            elif rng < _BOT:
                rng = (-low) & (_BOT - 1)
            else:
                break
            out.append((low >> 24) & 0xFF)
            low = (low << 8) & 0xFFFFFFFF
            rng = (rng << 8) & 0xFFFFFFFF
        f.update(byte)
    for _ in range(4):
        out.append((low >> 24) & 0xFF)
        low = (low << 8) & 0xFFFFFFFF
    return bytes(out)


def decode(data: bytes, n: int) -> bytes:
    f = _Freq()
    low = 0
    rng = 0xFFFFFFFF
    code = 0
    pos = 0
    for _ in range(4):
        code = ((code << 8) | (data[pos] if pos < len(data) else 0)) & 0xFFFFFFFF
        pos += 1
    out = bytearray()
    for _ in range(n):
        rng //= f.total
        val = (code - low) // rng
        s = f.find(val)
        low += f.cumfreq(s) * rng
        rng *= int(f.freq[s])
        low &= 0xFFFFFFFFFFFF
        while True:
            if (low ^ (low + rng)) < _TOP:
                pass
            elif rng < _BOT:
                rng = (-low) & (_BOT - 1)
            else:
                break
            code = ((code << 8) | (data[pos] if pos < len(data) else 0)) & 0xFFFFFFFF
            pos += 1
            low = (low << 8) & 0xFFFFFFFF
            rng = (rng << 8) & 0xFFFFFFFF
        out.append(s)
        f.update(s)
    return bytes(out)
