"""Permutohedral-lattice Gaussian filtering (PCL's ``Permutohedral``;
Adams, Baek and Davis, "Fast High-Dimensional Filtering Using the
Permutohedral Lattice", 2010).

Counterpart of ``pcl_tpu/ml/permutohedral.py``. ``build_lattice`` is host
numpy, copied, so the lattice (offsets, barycentric weights, blur
neighbours) is the JAX package's bit for bit. ``_compute`` filters on the
device: the splat adds the barycentric-weighted values onto the lattice rows
in row order on either device (``ops.segsum.add_rows``: ROADMAP C28, C84),
so every run repeats bitwise, the blur runs the ``d + 1`` directions in order, each
``v + (v[n1] + v[n2]) / 2`` against a zero sentinel row, and the slice is
the barycentric-weighted gather times ``alpha = 1 / (1 + 2^-d)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.ops.segsum import add_rows


class Lattice(NamedTuple):
    offsets: np.ndarray       # [N, d+1] int32 lattice-row index per vertex
    barycentric: np.ndarray   # [N, d+1] float32
    blur_n1: np.ndarray       # [d+1, M] int32 (M = missing sentinel)
    blur_n2: np.ndarray       # [d+1, M] int32
    m: int                    # number of lattice points
    d: int                    # feature dimension


def build_lattice(feat: np.ndarray) -> Lattice:
    """Host-side lattice construction for features [N, d]."""
    feat = np.asarray(feat, np.float32)
    N, d = feat.shape
    # elevation y = E f (permutohedral.cpp:94-115)
    inv_std = np.sqrt(2.0 / 3.0) * (d + 1)
    scale = inv_std / np.sqrt((np.arange(d) + 2.0) * (np.arange(d) + 1.0))
    cf = feat * scale[None, :]                              # [N, d]
    elevated = np.zeros((N, d + 1), np.float32)
    # elevated[j] = sum_{i > j} cf[i-1] - j * cf[j-1]; elevated[0] = sum cf
    suffix = np.concatenate(
        [np.cumsum(cf[:, ::-1], axis=1)[:, ::-1], np.zeros((N, 1))], axis=1)
    elevated[:, 0] = suffix[:, 0]
    js = np.arange(1, d + 1)
    elevated[:, 1:] = suffix[:, 1:] - js[None, :] * cf
    # closest 0-colored remainder point (cpp:117-125)
    rd = np.floor(0.5 + elevated / (d + 1))
    rem0 = rd * (d + 1)
    sumv = rd.sum(axis=1).astype(np.int32)
    # rank differential (cpp:127-136): rank(i) = #elements ranked above
    # tmp_i (descending; ties keep the earlier index first, matching the
    # reference's pair loop where the tie increments the later index)
    tmp = elevated - rem0
    order = np.argsort(-tmp, axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order,
                      np.broadcast_to(np.arange(d + 1), order.shape), axis=1)
    rank = rank.astype(np.int32)
    # bring off-plane points back (cpp:139-149)
    rank = rank + sumv[:, None]
    low = rank < 0
    rank = np.where(low, rank + d + 1, rank)
    rem0 = np.where(low, rem0 + d + 1, rem0)
    high = rank > d
    rank = np.where(high, rank - (d + 1), rank)
    rem0 = np.where(high, rem0 - (d + 1), rem0)
    # barycentric coordinates (cpp:151-159)
    v = (elevated - rem0) / (d + 1)
    bary = np.zeros((N, d + 2), np.float32)
    rows = np.repeat(np.arange(N), d + 1)
    np.add.at(bary, (rows, (d - rank).ravel()), v.ravel())
    np.add.at(bary, (rows, (d + 1 - rank).ravel()), -v.ravel())
    bary[:, 0] += 1.0 + bary[:, d + 1]
    barycentric = bary[:, : d + 1]
    # canonical simplex (cpp:83-88): canonical[j, r] = r if j <= d-r
    # else r - (d+1)
    jj, rr = np.meshgrid(np.arange(d + 1), np.arange(d + 1), indexing="ij")
    canonical = np.where(jj <= d - rr, rr, rr - (d + 1)).astype(np.int32)
    # simplex-vertex keys (cpp:161-166): key_r[j] = rem0[j] +
    # canonical[rank[j], r], stored for j < d
    keys = (rem0[:, None, :d]
            + canonical[rank[:, None, :d],
                        np.arange(d + 1)[None, :, None]]).astype(np.int32)
    flat_keys = keys.reshape(-1, d)                         # [(d+1)N, d]
    uniq, inverse = np.unique(flat_keys, axis=0, return_inverse=True)
    M = uniq.shape[0]
    offsets = inverse.reshape(N, d + 1).astype(np.int32)

    # blur neighbors (cpp:215-256): axis j neighbor n1 = key - 1 with
    # n1[j] = key[j] + d (and n2 the mirror); resolve via lexsorted rows
    def lookup(q):
        # q [M, d] -> index into uniq or M (missing)
        lex = np.lexsort(uniq.T[::-1])
        su = uniq[lex]
        pos = np.searchsorted(
            su.view([("", su.dtype)] * d).ravel(),
            np.ascontiguousarray(q).view([("", q.dtype)] * d).ravel())
        pos = np.clip(pos, 0, M - 1)
        hit = (su[pos] == q).all(axis=1)
        return np.where(hit, lex[pos], M).astype(np.int32)

    blur_n1 = np.zeros((d + 1, M), np.int32)
    blur_n2 = np.zeros((d + 1, M), np.int32)
    for j in range(d + 1):
        n1 = uniq - 1
        n2 = uniq + 1
        if j < d:
            n1[:, j] = uniq[:, j] + d
            n2[:, j] = uniq[:, j] - d
        # j == d: the omitted coordinate changes; stored coords all shift
        # by -1/+1 which is exactly uniq -+ 1 (sum-zero closure)
        blur_n1[j] = lookup(n1)
        blur_n2[j] = lookup(n2)
    return Lattice(offsets=offsets, barycentric=barycentric.astype(np.float32),
                   blur_n1=blur_n1, blur_n2=blur_n2, m=M, d=d)


def _compute(values: torch.Tensor, offsets: torch.Tensor, barycentric: torch.Tensor,
             blur_n1: torch.Tensor, blur_n2: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """Splat, blur and slice ``values [N, C]`` on the lattice's tensors."""
    n, c = values.shape
    contrib = (values[:, None, :] * barycentric[:, :, None]).reshape(-1, c)
    lat = torch.zeros((m + 1, c), dtype=torch.float32, device=values.device)
    lat = add_rows(lat, offsets.reshape(-1), contrib)
    lat[m] = 0.0                                            # the zero sentinel
    for j in range(d + 1):
        core = lat[:m] + 0.5 * (lat[blur_n1[j].long()] + lat[blur_n2[j].long()])
        lat = torch.cat([core, lat[m:]])
    alpha = float(np.float32(1.0 / (1.0 + 2.0 ** (-d))))
    gathered = lat[offsets.long()]                          # [N, d+1, C]
    return torch.sum(gathered * barycentric[:, :, None], dim=1) * alpha


class PermutohedralFilter:
    """Build once, filter many: a Gaussian filter over features ``[N, d]``
    whose lattice tensors live on ``device`` (default CUDA)."""

    def __init__(self, feat: np.ndarray, device=None):
        dev = _device(device)
        self.lat = build_lattice(feat)
        self._off = torch.tensor(self.lat.offsets, device=dev)
        self._bar = torch.tensor(self.lat.barycentric, device=dev)
        self._n1 = torch.tensor(self.lat.blur_n1, device=dev)
        self._n2 = torch.tensor(self.lat.blur_n2, device=dev)

    def compute(self, values) -> torch.Tensor:
        """Filter ``values [N, C]`` (unnormalised, as PCL's)."""
        v = torch.as_tensor(values, dtype=torch.float32, device=self._off.device)
        return _compute(v, self._off, self._bar, self._n1, self._n2, self.lat.m, self.lat.d)
