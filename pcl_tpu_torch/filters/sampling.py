"""Subsampling filters: random, farthest-point and normal-space.

Counterpart of ``pcl_tpu/filters/sampling.py`` (PCL's RandomSample,
FarthestPointSampling, NormalSpaceSampling). The JAX functions take a
``jax.random`` key; the port cannot draw JAX's threefry streams, so each
function is a sampler (a ``torch.Generator``, seeded 0 on the cloud's device
unless given) and a deterministic core that takes the draws (ROADMAP C17):
``random_sample_core(cloud, n, z)``, ``farthest_point_sample_core(cloud, n,
start)`` and ``normal_space_sample_core(cloud, n, z)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.sac.ransac import categorical, generator


def _picked(cloud: Cloud, sel: torch.Tensor, n_samples: int) -> Cloud:
    valid = torch.arange(n_samples, device=sel.device) < torch.clamp(cloud.count, max=n_samples)
    return cloud.take(sel, valid=valid)


def random_sample_core(cloud: Cloud, n_samples: int, z: torch.Tensor) -> Cloud:
    """Up to ``n_samples`` valid points without replacement: the points of
    the smallest draws ``z [N]`` (uniform in [0, 1))."""
    order = torch.argsort(torch.where(cloud.mask, z, 2.0), stable=True)
    return _picked(cloud, order[:n_samples], n_samples)


def random_sample(cloud: Cloud, n_samples: int, gen: Optional[torch.Generator] = None) -> Cloud:
    """Uniformly sample up to ``n_samples`` valid points without
    replacement."""
    g = generator(cloud.xyz.device, gen)
    z = torch.rand(cloud.capacity, generator=g, device=cloud.xyz.device)
    return random_sample_core(cloud, n_samples, z)


def farthest_point_sample_core(cloud: Cloud, n_samples: int, start) -> Cloud:
    """Farthest-point sampling from the point ``start``: each next sample is
    the valid point farthest from those chosen (the first index on a tie).
    ``n_samples`` masked distance updates, on the device with no read-back."""
    xyz = cloud.xyz
    last = torch.as_tensor(start, dtype=torch.int64).reshape(1).to(xyz.device)
    mind = torch.full((cloud.capacity,), math.inf, dtype=torch.float32, device=xyz.device)
    sel = [last]
    for _ in range(1, n_samples):
        diff = xyz - xyz.index_select(0, last)
        d = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
        mind = torch.minimum(mind, d)
        last = torch.argmax(torch.where(cloud.mask, mind, -math.inf)).reshape(1)
        sel.append(last)
    return _picked(cloud, torch.cat(sel), n_samples)


def farthest_point_sample(cloud: Cloud, n_samples: int,
                          gen: Optional[torch.Generator] = None) -> Cloud:
    """Iterative farthest-point sampling from a valid point drawn
    uniformly."""
    g = generator(cloud.xyz.device, gen)
    start = categorical(g, cloud.mask.to(torch.float32), (1,))
    return farthest_point_sample_core(cloud, n_samples, start)


def normal_space_sample_core(cloud: Cloud, n_samples: int, z: torch.Tensor,
                             bins_per_axis: int = 4) -> Cloud:
    """Sampling spread evenly over a histogram of normal directions: the
    points sorted by bin and draw ``z [N]``, taken round-robin over the bins
    (rank within the bin, then the draw of the sorted position, as the JAX
    package scores it)."""
    if ATTR_NORMAL not in cloud.attrs:
        raise ValueError("normal_space_sample requires normals")
    b = bins_per_axis
    q = torch.clamp(((cloud.attrs[ATTR_NORMAL] * 0.5 + 0.5) * b).to(torch.int32), 0, b - 1)
    bin_id = (q[:, 0] * b + q[:, 1]) * b + q[:, 2]
    by_z = torch.argsort(z, stable=True)
    order = by_z[torch.argsort(bin_id[by_z], stable=True)]       # lexsort (z, bin)
    sorted_bin = bin_id[order]
    first = torch.ones_like(sorted_bin, dtype=torch.bool)
    first[1:] = sorted_bin[1:] != sorted_bin[:-1]
    pos = torch.arange(cloud.capacity, device=z.device)
    seg_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = pos - seg_start
    score = torch.where(cloud.mask[order], rank.to(torch.float32) + z * 0.5, math.inf)
    pick = torch.argsort(score, stable=True)[:n_samples]
    return _picked(cloud, order[pick], n_samples)


def normal_space_sample(cloud: Cloud, n_samples: int, gen: Optional[torch.Generator] = None,
                        bins_per_axis: int = 4) -> Cloud:
    """Sample evenly over the normal-direction histogram (needs the
    ``normal`` attribute)."""
    g = generator(cloud.xyz.device, gen)
    z = torch.rand(cloud.capacity, generator=g, device=cloud.xyz.device)
    return normal_space_sample_core(cloud, n_samples, z, bins_per_axis)
