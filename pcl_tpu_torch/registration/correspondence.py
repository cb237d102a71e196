"""Correspondence estimation by batched 1-NN matching.

Counterpart of ``determine_correspondences`` and
``determine_reciprocal_correspondences`` in
``pcl_tpu/registration/correspondence.py``: per source point, a target index,
its squared distance and a validity flag (distance gate and masks). Normal
shooting is ported with the normals slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcl_tpu_torch.search import bruteforce


class Correspondences(NamedTuple):
    """``index[i]`` is the target matched to source point ``i``."""
    index: torch.Tensor    # [N] int32
    sqdist: torch.Tensor   # [N] f32
    valid: torch.Tensor    # [N] bool


def _gate(max_dist: float) -> float:
    """``max_dist`` squared in float32, as a Python float."""
    return float(np.float32(max_dist) ** 2)


def determine_correspondences(
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_xyz: torch.Tensor,
    tgt_mask: torch.Tensor,
    max_dist: float = float("inf"),
) -> Correspondences:
    """1-NN in the target for every source point, gated by ``max_dist``."""
    idx, d2 = bruteforce.nn1(tgt_xyz, tgt_mask, src_xyz)
    valid = src_mask & torch.isfinite(d2) & (d2 <= _gate(max_dist))
    return Correspondences(idx, d2, valid)


def determine_reciprocal_correspondences(
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_xyz: torch.Tensor,
    tgt_mask: torch.Tensor,
    max_dist: float = float("inf"),
) -> Correspondences:
    """Keep only the pairs that are mutual nearest neighbours."""
    fwd = determine_correspondences(src_xyz, src_mask, tgt_xyz, tgt_mask, max_dist)
    back_idx, _ = bruteforce.nn1(src_xyz, src_mask, tgt_xyz)
    n = src_xyz.shape[0]
    fwd_c = torch.clamp(fwd.index.long(), 0, tgt_xyz.shape[0] - 1)
    mutual = back_idx[fwd_c] == torch.arange(n, dtype=torch.int32, device=src_xyz.device)
    return Correspondences(fwd.index, fwd.sqdist, fwd.valid & mutual)
