"""Multiscale feature persistence.

Counterpart of ``pcl_tpu/features/persistence.py`` (PCL's
MultiscaleFeaturePersistence): a feature computed at several scales; a point
is persistent when its descriptor lies further than ``alpha`` standard
deviations beyond the mean distance from the scale's mean descriptor at
every scale.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

_EPS = 1e-12


def feature_persistence(
    feature_fn: Callable[[float], torch.Tensor],
    scales: Sequence[float],
    mask: torch.Tensor,
    *,
    alpha: float = 1.0,
    distance: str = "l1",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(persistent [N] bool, distances [S, N])``. ``feature_fn(scale)``
    returns the ``[N, D]`` descriptor tensor at that scale; ``distance`` is
    ``"l1"``, ``"l2"`` or ``"chisq"``."""
    w = mask.to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    persistent = mask
    dists = []
    for s in scales:
        f = feature_fn(float(s))
        mu = torch.sum(f * w[:, None], dim=0) / wsum
        if distance == "l1":
            d = torch.sum((f - mu).abs(), dim=-1)
        elif distance == "l2":
            d = torch.linalg.vector_norm(f - mu, dim=-1)
        elif distance == "chisq":
            d = torch.sum((f - mu) ** 2 / torch.clamp(f + mu, min=_EPS), dim=-1)
        else:
            raise ValueError(f"unknown distance {distance!r}")
        d_mu = torch.sum(d * w) / wsum
        d_sd = torch.sqrt(torch.clamp(torch.sum(w * (d - d_mu) ** 2) / wsum, min=0.0))
        persistent = persistent & (d > d_mu + alpha * d_sd)
        dists.append(d)
    return persistent, torch.stack(dists)
