"""Dense CRF: mean-field inference with Gaussian pairwise potentials (PCL's
``DenseCrf`` with its Gaussian and bilateral pairwise potentials).

Counterpart of ``pcl_tpu/ml/densecrf.py``. The message pass filters the
posteriors with the permutohedral lattice (``ml/permutohedral.py``),
normalised per point, or with the bilateral grid of ``_grid_filter``
(``filter_impl="grid"``): a multilinear splat over the ``2^F`` corners of a
dense ``n_bins^F`` grid, a rolled 1-2-1 blur along each axis and a
multilinear slice. Splats add in corner then row order on either device
(``ops.segsum.add_rows``: ROADMAP C28, C84), so every run repeats bitwise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.casts import xla_int32
from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.ops.segsum import add_rows


def _corners(i0: torch.Tensor, frac: torch.Tensor, n_bins: int, strides: torch.Tensor):
    """For each of the ``2^F`` corners: the flat cell of each row and its
    multilinear weight."""
    F = frac.shape[1]
    for corner in range(1 << F):
        bits = torch.tensor([(corner >> b) & 1 for b in range(F)], dtype=torch.int32,
                            device=frac.device)
        w = torch.prod(torch.where(bits[None, :] == 1, frac, 1.0 - frac), dim=1)
        idx = torch.sum(torch.clamp(i0 + bits[None, :], 0, n_bins - 1) * strides[None, :], dim=1)
        yield idx.long(), w


def _grid_filter(q: torch.Tensor, feat: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Gaussian filter of ``q [N, C]`` under the feature metric ``feat [N,
    F]`` (scaled so that sigma is one bin), normalised by the filtered
    ones."""
    n, c = q.shape
    F = feat.shape[1]
    lo = torch.amin(feat, dim=0, keepdim=True)
    g = torch.clamp(feat - lo + 1.0, 0.0, n_bins - 1.001)
    i0 = xla_int32(torch.floor(g))
    frac = g - i0
    strides = torch.tensor(np.cumprod([1] + [n_bins] * (F - 1))[::-1].copy(),
                           dtype=torch.int32, device=q.device)
    qw = torch.cat([q, torch.ones((n, 1), dtype=q.dtype, device=q.device)], dim=1)
    flat = torch.zeros((n_bins ** F, c + 1), dtype=torch.float32, device=q.device)
    for idx, w in _corners(i0, frac, n_bins, strides):
        add_rows(flat, idx, qw * w[:, None])
    vol = flat.reshape((n_bins,) * F + (c + 1,))
    for ax in range(F):
        vol = 0.25 * torch.roll(vol, 1, ax) + 0.5 * vol + 0.25 * torch.roll(vol, -1, ax)
    flat = vol.reshape(-1, c + 1)
    out = torch.zeros((n, c + 1), dtype=torch.float32, device=q.device)
    for idx, w in _corners(i0, frac, n_bins, strides):
        out = out + flat[idx] * w[:, None]
    return out[:, :c] / torch.clamp(out[:, c:], min=1e-9)


class DenseCRF:
    """A fully connected CRF over N points with Gaussian pairwise kernels,
    run on ``device`` (default CUDA)."""

    def __init__(self, n_points: int, n_classes: int, device=None):
        self.n = n_points
        self.c = n_classes
        self.device = _device(device)
        self.unary: Optional[np.ndarray] = None          # [N, C] energies (-log P)
        self.kernels: List[Tuple[np.ndarray, float, int]] = []

    def set_unary_energy(self, unary: np.ndarray) -> None:
        self.unary = np.asarray(unary, np.float32)

    def add_pairwise_gaussian(self, xyz: np.ndarray, sx: float, w: float = 3.0,
                              n_bins: int = 24) -> None:
        """The smoothness kernel ``exp(-|p_i - p_j|^2 / 2 sx^2)``."""
        self.kernels.append((np.asarray(xyz, np.float32) / sx, float(w), n_bins))

    def add_pairwise_bilateral(self, xyz: np.ndarray, rgb: np.ndarray, sx: float, sr: float,
                               w: float = 10.0, n_bins: int = 12) -> None:
        """The appearance kernel over ``(xyz / sx, rgb / sr)``."""
        f = np.concatenate([np.asarray(xyz, np.float32) / sx,
                            np.asarray(rgb, np.float32) / sr], axis=1)
        self.kernels.append((f, float(w), n_bins))

    def inference(self, n_iterations: int = 10,
                  filter_impl: str = "permutohedral") -> np.ndarray:
        """Damped mean-field updates ``Q <- Q / 2 + softmax(-unary + sum_k
        w_k G_k Q) / 2``; returns the posteriors ``[N, C]`` (host)."""
        dev = self.device
        u = torch.tensor(self.unary, device=dev)
        q = torch.softmax(-u, dim=1)
        if filter_impl == "permutohedral":
            from pcl_tpu_torch.ml.permutohedral import PermutohedralFilter
            pfs = [(PermutohedralFilter(f, device=dev), w) for f, w, _b in self.kernels]
            ones = torch.ones((self.n, 1), dtype=torch.float32, device=dev)
            norms = [torch.clamp(pf.compute(ones), min=1e-9) for pf, _w in pfs]
        else:
            feats = [(torch.tensor(f, device=dev), w, b) for f, w, b in self.kernels]
        for _ in range(n_iterations):
            msg = torch.zeros_like(q)
            if filter_impl == "permutohedral":
                for (pf, w), nrm in zip(pfs, norms):
                    msg = msg + w * (pf.compute(q) / nrm)
            else:
                for f, w, b in feats:
                    msg = msg + w * _grid_filter(q, f, b)
            # damped: the normalised filters keep a self-weight, and the plain
            # fixed-point iteration can oscillate with period 2
            q = 0.5 * q + 0.5 * torch.softmax(-u + msg, dim=1)
        return q.cpu().numpy()

    def map_labels(self, n_iterations: int = 10) -> np.ndarray:
        return self.inference(n_iterations).argmax(1).astype(np.int32)
