"""Native host runtime: C++ kd-tree, Morton keys and voxel binning.

Counterpart of the JAX package's ``native`` module, over the port's own copy of
the C++ source, ``csrc/pcl_native.cpp``. The library is built at first use
by ``ops/_build.host_library`` (the host's ``g++``, OpenMP where it links)
into ``build/kernels/``, keyed by a hash of the source and the flags.

It stays a host module, as in the JAX package: numpy arrays in, numpy
arrays out. A torch tensor on any device is taken too, copied to the host.
Every entry point keeps the JAX package's numpy fallback, which runs when
no compiler builds the library; ``available()`` says which of the two runs.

Traits of the reference kept here (ROADMAP C99-C101):

- ``morton_argsort`` is ``std::sort`` on the codes alone, which is not
  stable; the fallback's ``np.argsort(kind="stable")`` is. Points with equal
  codes may come in another order.
- ``voxel_centroids`` bins relative to the cloud's minimum, by a product
  with ``1 / leaf``: not ``voxel_downsample``'s absolute ``floor(xyz / leaf)``
  grid, so its voxels are not B2's.
- Among equally distant points the kd-tree returns whichever its traversal
  meets first, not the lowest index.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pcl_kdtree_build.restype = ctypes.c_void_p
    lib.pcl_kdtree_build.argtypes = [_f32p, ctypes.c_int32]
    lib.pcl_kdtree_free.argtypes = [ctypes.c_void_p]
    lib.pcl_kdtree_knn.argtypes = [
        ctypes.c_void_p, _f32p, ctypes.c_int32, ctypes.c_int32, _f32p, _i32p, _i32p]
    lib.pcl_kdtree_radius.argtypes = [
        ctypes.c_void_p, _f32p, ctypes.c_int32, ctypes.c_float, ctypes.c_int32, _f32p, _i32p,
        _i32p]
    lib.pcl_morton_encode.argtypes = [_f32p, ctypes.c_int32, _u64p]
    lib.pcl_morton_argsort.argtypes = [_f32p, ctypes.c_int32, _i32p]
    lib.pcl_voxel_centroids.restype = ctypes.c_int32
    lib.pcl_voxel_centroids.argtypes = [_f32p, ctypes.c_int32, ctypes.c_float, _f32p]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    """The bound library, built at the first call; None where no compiler
    builds it (the numpy fallbacks run then)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            from pcl_tpu_torch.ops import _build
            try:
                _lib = _bind(_build.host_library("pcl_native"))
            except RuntimeError:
                _lib = None
        return _lib


def available() -> bool:
    """Whether the C++ library runs (else the numpy fallbacks do)."""
    return _get() is not None


def _as_f32(a) -> np.ndarray:
    if hasattr(a, "detach"):                  # a torch tensor, on any device
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32))


class KdTree:
    """Exact 3-D kd-tree (native C++ when available, numpy fallback).

    Mirrors pcl::KdTreeFLANN (kdtree/include/pcl/kdtree/kdtree_flann.h:132):
    ``knn`` == nearestKSearch, ``radius`` == radiusSearch (sorted ascending).
    """

    def __init__(self, points) -> None:
        self._pts = _as_f32(points).reshape(-1, 3)
        self._n = self._pts.shape[0]
        lib = _get()
        self._lib = lib
        self._h = None
        if lib is not None:
            self._h = ctypes.c_void_p(lib.pcl_kdtree_build(self._pts, self._n))

    def __del__(self):
        try:
            if self._h is not None and self._lib is not None:
                self._lib.pcl_kdtree_free(self._h)
        except Exception:
            pass

    def knn(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (dist2 [m, k], idx [m, k]); idx = -1 and dist2 = inf where
        fewer than k points exist."""
        q = _as_f32(queries).reshape(-1, 3)
        m = q.shape[0]
        k = int(k)
        if self._h is not None:
            d2 = np.full((m, k), np.inf, np.float32)
            ii = np.full((m, k), -1, np.int32)
            cnt = np.zeros((m,), np.int32)
            self._lib.pcl_kdtree_knn(self._h, q, m, k, d2, ii, cnt)
            tail = cnt[:, None] <= np.arange(k)[None, :]
            d2[tail] = np.inf
            ii[tail] = -1
            return d2, ii
        return _knn_numpy(self._pts, q, k)

    def radius(self, queries, r: float, cap: int = 64
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (dist2 [m, cap], idx [m, cap], count [m]); count may
        exceed cap (the overflow signal), the entries beyond are dropped."""
        q = _as_f32(queries).reshape(-1, 3)
        m = q.shape[0]
        cap = int(cap)
        if self._h is not None:
            d2 = np.full((m, cap), np.inf, np.float32)
            ii = np.full((m, cap), -1, np.int32)
            cnt = np.zeros((m,), np.int32)
            self._lib.pcl_kdtree_radius(
                self._h, q, m, ctypes.c_float(float(r)), cap, d2, ii, cnt)
            tail = np.minimum(cnt, cap)[:, None] <= np.arange(cap)[None, :]
            d2[tail] = np.inf
            ii[tail] = -1
            return d2, ii, cnt
        return _radius_numpy(self._pts, q, float(r), cap)


def _knn_numpy(pts, q, k):
    m = q.shape[0]
    if pts.shape[0] == 0:
        return (np.full((m, k), np.inf, np.float32),
                np.full((m, k), -1, np.int32))
    d2_all = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    kk = min(k, pts.shape[0])
    part = np.argpartition(d2_all, kk - 1, axis=1)[:, :kk]
    d2p = np.take_along_axis(d2_all, part, axis=1)
    order = np.argsort(d2p, axis=1)
    ii = np.take_along_axis(part, order, axis=1).astype(np.int32)
    d2 = np.take_along_axis(d2p, order, axis=1).astype(np.float32)
    if kk < k:
        pad = k - kk
        d2 = np.pad(d2, ((0, 0), (0, pad)), constant_values=np.inf)
        ii = np.pad(ii, ((0, 0), (0, pad)), constant_values=-1)
    return d2, ii


def _radius_numpy(pts, q, r, cap):
    m = q.shape[0]
    d2o = np.full((m, cap), np.inf, np.float32)
    iio = np.full((m, cap), -1, np.int32)
    cnt = np.zeros((m,), np.int32)
    if pts.shape[0] == 0:
        return d2o, iio, cnt
    d2_all = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    within = d2_all <= r * r
    cnt = within.sum(axis=1).astype(np.int32)
    for j in range(m):
        sel = np.nonzero(within[j])[0]
        d2s = d2_all[j, sel]
        order = np.argsort(d2s)[:cap]
        take = sel[order]
        d2o[j, : take.size] = d2s[order]
        iio[j, : take.size] = take
    return d2o, iio, cnt


def morton_argsort(points) -> np.ndarray:
    """Permutation ordering points along a 63-bit Morton curve over their
    bounding box (gpu/octree's octree_builder.cu ordering, on the host)."""
    pts = _as_f32(points).reshape(-1, 3)
    n = pts.shape[0]
    lib = _get()
    if lib is not None:
        order = np.empty((n,), np.int32)
        lib.pcl_morton_argsort(pts, n, order)
        return order
    codes = morton_encode(pts)
    return np.argsort(codes, kind="stable").astype(np.int32)


def morton_encode(points) -> np.ndarray:
    """21-bit-per-axis Morton codes ``[n]`` uint64 over the bounding box."""
    pts = _as_f32(points).reshape(-1, 3)
    n = pts.shape[0]
    lib = _get()
    if lib is not None:
        codes = np.empty((n,), np.uint64)
        lib.pcl_morton_encode(pts, n, codes)
        return codes
    return _morton_encode_numpy(pts)


def _morton_encode_numpy(pts):
    n = pts.shape[0]
    lo = pts.min(axis=0) if n else np.zeros(3, np.float32)
    hi = pts.max(axis=0) if n else np.ones(3, np.float32)
    w = np.where(hi - lo > 0, hi - lo, 1.0)
    qv = ((pts - lo) / w * ((1 << 21) - 1)).astype(np.uint64)

    def expand(v):
        v &= np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (expand(qv[:, 0]) | (expand(qv[:, 1]) << np.uint64(1))
            | (expand(qv[:, 2]) << np.uint64(2)))


def voxel_centroids(points, leaf: float) -> np.ndarray:
    """Host VoxelGrid: the mean of the points of each occupied voxel of size
    ``leaf`` (filters/impl/voxel_grid.hpp:597 semantics, the centroid of all
    points), voxels counted from the cloud's minimum."""
    pts = _as_f32(points).reshape(-1, 3)
    n = pts.shape[0]
    if n == 0:
        return pts
    lib = _get()
    if lib is not None:
        out = np.empty((n, 3), np.float32)
        nv = lib.pcl_voxel_centroids(pts, n, ctypes.c_float(float(leaf)), out)
        return out[:nv].copy()
    return _voxel_centroids_numpy(pts, leaf)


def _voxel_centroids_numpy(pts, leaf):
    n = pts.shape[0]
    lo = pts.min(axis=0)
    key = np.floor((pts - lo) / leaf).astype(np.int64)
    key = (key[:, 0] * 2097152 + key[:, 1]) * 2097152 + key[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    pts_s = pts[order]
    starts = np.r_[0, np.nonzero(np.diff(key_s))[0] + 1]
    counts = np.diff(np.r_[starts, n])
    sums = np.add.reduceat(pts_s, starts, axis=0)
    return (sums / counts[:, None]).astype(np.float32)
