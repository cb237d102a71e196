"""Random cloud generation and string splitting.

Counterpart of ``pcl_tpu/utils/generate.py``:

- CloudGenerator (reference common/generate.h, common/random.h): organized
  clouds of per-axis uniform or normal samples. Each is a sampler, which
  draws unit samples ``[3, n]`` with a ``torch.Generator`` where the JAX
  package takes a key, and a core that takes the draws (ROADMAP C17): the
  port cannot repeat the JAX package's draws, and its tests feed the cores
  the JAX draws.
- ``split`` (reference io/split.h): tokens between any of the delimiter
  characters, empty tokens dropped.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from pcl_tpu_torch.core.cloud import Cloud, make_cloud


def generate_cloud_uniform_core(
    draws: torch.Tensor,
    width: int,
    height: int = 1,
    ranges: Sequence[Tuple[float, float]] = ((0.0, 1.0),) * 3,
) -> Cloud:
    """The cloud of unit uniform draws ``[3, n]`` in ``[0, 1)``, axis k
    scaled to ``[lo, hi)`` as ``jax.random.uniform`` scales:
    ``max(lo, u (hi - lo) + lo)``."""
    dev = draws.device
    cols = []
    for u, (lo, hi) in zip(draws, ranges):
        lo_t = torch.tensor(lo, dtype=torch.float32, device=dev)
        hi_t = torch.tensor(hi, dtype=torch.float32, device=dev)
        cols.append(torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t))
    return make_cloud(torch.stack(cols, dim=1), width=width, height=height, device=dev)


def generate_cloud_normal_core(
    draws: torch.Tensor,
    width: int,
    height: int = 1,
    params: Sequence[Tuple[float, float]] = ((0.0, 1.0),) * 3,
) -> Cloud:
    """The cloud of standard normal draws ``[3, n]``, axis k ``mu + sd
    z``."""
    cols = [mu + sd * z for z, (mu, sd) in zip(draws, params)]
    return make_cloud(torch.stack(cols, dim=1), width=width, height=height,
                      device=draws.device)


def generate_cloud_uniform(
    generator: torch.Generator,
    width: int,
    height: int = 1,
    ranges: Sequence[Tuple[float, float]] = ((0.0, 1.0),) * 3,
) -> Cloud:
    """Organized cloud with per-axis uniform samples in ``[lo, hi)``
    (CloudGenerator<UniformGenerator>, generate.h:58), drawn on the
    generator's device."""
    draws = torch.rand((3, width * height), generator=generator, device=generator.device)
    return generate_cloud_uniform_core(draws, width, height, ranges)


def generate_cloud_normal(
    generator: torch.Generator,
    width: int,
    height: int = 1,
    params: Sequence[Tuple[float, float]] = ((0.0, 1.0),) * 3,
) -> Cloud:
    """Organized cloud with per-axis normal samples ``(mean, sigma)``
    (CloudGenerator<NormalGenerator>), drawn on the generator's device."""
    draws = torch.randn((3, width * height), generator=generator, device=generator.device)
    return generate_cloud_normal_core(draws, width, height, params)


def split(text: str, delimiters: str = " \r\t") -> List[str]:
    """Tokenize on any delimiter character, skipping empty tokens
    (pcl::split, io/split.h)."""
    out: List[str] = []
    cur: List[str] = []
    for ch in text:
        if ch in delimiters:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out
