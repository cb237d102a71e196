"""Temporal data buffers for grabber streams — single / median / average.

Equivalents of pcl::io::SingleBuffer / MedianBuffer / AverageBuffer
(reference: io/include/pcl/io/buffers.h + impl — the per-pixel temporal
filters the depth-sense grabbers run over incoming frames). Each buffer
holds frames of ``size`` values over a sliding ``window``:

- SingleBuffer: latest frame only;
- MedianBuffer: per-element UPPER median (index n_valid // 2 of the
  sorted valid values) over the window, invalid samples excluded; all-
  invalid elements report invalid (buffers.h semantics, pinned by
  test/io/test_buffers.cpp including the invalid-push vectors);
- AverageBuffer: per-element mean of the valid window samples (integer
  inputs keep integer division-toward-zero like the C++ arithmetic).

Invalid = NaN for floats, 0 for integer types (buffer_traits).
Vectorized numpy over the frame axis; frames are [size] arrays.

Counterpart of ``pcl_tpu/io/buffers.py``: a copy of its numpy code; the
buffers hold host frames.
"""

from __future__ import annotations

import numpy as np


def _is_invalid(frame: np.ndarray) -> np.ndarray:
    if frame.dtype.kind == "f":
        return np.isnan(frame)
    return frame == 0


def _invalid_value(dtype) -> float:
    return np.nan if np.dtype(dtype).kind == "f" else 0


class SingleBuffer:
    """Latest frame, unfiltered (buffers.h SingleBuffer)."""

    def __init__(self, size: int, dtype=np.float32):
        self._size = size
        self._data = np.full(size, _invalid_value(dtype), dtype)

    @property
    def size(self) -> int:
        return self._size

    def push(self, frame) -> None:
        frame = np.asarray(frame)
        assert frame.shape == (self._size,)
        self._data = frame.copy()

    def __getitem__(self, i):
        return self._data[i]

    @property
    def data(self) -> np.ndarray:
        return self._data.copy()


class _WindowBuffer(SingleBuffer):
    def __init__(self, size: int, window: int, dtype=np.float32):
        super().__init__(size, dtype)
        assert window >= 1
        self._window = window
        self._frames = np.full((window, size), _invalid_value(dtype), dtype)
        self._count = 0

    def push(self, frame) -> None:
        frame = np.asarray(frame)
        assert frame.shape == (self._size,)
        self._frames[self._count % self._window] = frame
        self._count += 1
        self._data = self._reduce()

    def _valid_stack(self):
        n = min(self._count, self._window)
        stack = self._frames[:n]
        return stack, ~_is_invalid(stack)


class MedianBuffer(_WindowBuffer):
    """Per-element upper median of the valid window samples."""

    def _reduce(self) -> np.ndarray:
        stack, valid = self._valid_stack()
        n_valid = valid.sum(axis=0)
        # sort valid-first: invalids to +inf, take index n_valid // 2
        key = np.where(valid, stack.astype(np.float64), np.inf)
        key.sort(axis=0)
        idx = np.minimum(n_valid // 2, stack.shape[0] - 1)
        med = np.take_along_axis(key, idx[None, :], axis=0)[0]
        result = np.where(
            n_valid > 0, med, np.float64(
                np.nan if self._data.dtype.kind == "f" else 0))
        if self._data.dtype.kind == "f":
            return result.astype(self._data.dtype)
        return np.where(np.isfinite(result), result, 0).astype(
            self._data.dtype)


class AverageBuffer(_WindowBuffer):
    """Per-element mean of the valid window samples (C-style truncation
    for integer dtypes)."""

    def _reduce(self) -> np.ndarray:
        stack, valid = self._valid_stack()
        n_valid = valid.sum(axis=0)
        s = np.where(valid, stack.astype(np.float64), 0.0).sum(axis=0)
        mean = s / np.maximum(n_valid, 1)
        if self._data.dtype.kind == "f":
            return np.where(n_valid > 0, mean, np.nan).astype(
                self._data.dtype)
        return np.where(n_valid > 0, np.trunc(mean), 0).astype(
            self._data.dtype)
