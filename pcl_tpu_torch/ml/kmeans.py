"""K-means clustering (PCL's Kmeans).

Counterpart of ``pcl_tpu/ml/kmeans.py``: Lloyd iterations, an ``[N, k]``
distance argmin by the matrix-product identity and segment means, until the
largest centroid move is at most ``tol``. The JAX package draws the initial
centroids with ``jax.random.categorical``; here a sampler draws them
(``kmeans_init_indices``, ``torch.multinomial``) and a core takes the drawn
indices (``kmeans_core``), so the tests feed the core the JAX draws (ROADMAP
C17, C61). The core reads back one flag an iteration (C48).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.ops.segsum import add_rows


def kmeans_init_indices(mask: torch.Tensor, k: int,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``k`` initial centroid indices drawn with replacement, uniform over
    the valid rows."""
    w = mask.to(torch.float32)
    probs = w / torch.clamp(torch.sum(w), min=1.0)
    dev = mask.device if generator is None else generator.device
    return torch.multinomial((probs + 1e-30).to(dev), k, replacement=True,
                             generator=generator).to(mask.device)


def kmeans_core(x: torch.Tensor, mask: torch.Tensor, k: int, init_idx: torch.Tensor,
                max_iterations: int = 100, tol: float = 1e-5
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Lloyd iterations from ``x[init_idx]``: ``(centroids [k, D], labels [N]
    int32 (-1 where masked), iterations)``. An empty cluster keeps its
    centroid."""
    w = mask.to(torch.float32)
    x2 = torch.sum(x * x, dim=1)
    tol = float(np.float32(tol))

    def assign(cent):
        c2 = torch.sum(cent * cent, dim=1)
        dist = x2[:, None] + c2[None, :] - 2.0 * (x @ cent.T)
        return torch.where(mask, torch.argmin(dist, dim=1), k)

    cent = x[init_idx.long()]
    it = 0
    while it < max_iterations:
        lab = assign(cent)
        sums = add_rows(torch.zeros((k + 1, x.shape[1]), device=x.device), lab,
                        x * w[:, None])[:k]
        cnts = add_rows(torch.zeros(k + 1, device=x.device), lab, w)[:k]
        new = torch.where(cnts[:, None] > 0, sums / torch.clamp(cnts, min=1.0)[:, None], cent)
        shift = torch.amax(torch.linalg.vector_norm(new - cent, dim=1))
        cent, it = new, it + 1
        if not bool(shift > tol):
            break
    lab = assign(cent)
    return cent, torch.where(mask, lab, -1).to(torch.int32), it


def kmeans(x: torch.Tensor, mask: torch.Tensor, k: int,
           generator: Optional[torch.Generator] = None, max_iterations: int = 100,
           tol: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K-means of the valid rows of ``x [N, D]``: the sampler, then the core."""
    return kmeans_core(x, mask, k, kmeans_init_indices(mask, k, generator), max_iterations, tol)
