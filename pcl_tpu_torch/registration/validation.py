"""Transformation validation: accept or reject an estimated transform.

Counterpart of ``pcl_tpu/registration/validation.py`` (PCL's
TransformationValidationEuclidean): the mean squared NN distance of the
transformed source to the target over the pairs within ``max_range``, held
against ``threshold``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud
from pcl_tpu_torch.core.transforms import transform_points
from pcl_tpu_torch.registration import correspondence as corr_mod
from pcl_tpu_torch.registration.icp import _masked_mse


class ValidationResult(NamedTuple):
    score: torch.Tensor        # f32 mean squared NN distance (lower is better)
    is_valid: torch.Tensor     # bool: score <= threshold
    num_inliers: torch.Tensor  # int32


def validate_euclidean(source: Cloud, target: Cloud, transform: torch.Tensor, *,
                       max_range: float = float("inf"),
                       threshold: float = float("inf")) -> ValidationResult:
    """Score ``transform`` by the mean squared NN distance of the pairs
    within ``max_range`` and compare it with ``threshold``. Pairs past the
    range are selected out, not multiplied by 0 (ROADMAP C7)."""
    c = corr_mod.determine_correspondences(transform_points(transform, source.xyz), source.mask,
                                           target.xyz, target.mask, max_range)
    score = _masked_mse(c)
    return ValidationResult(score=score, is_valid=score <= float(np.float32(threshold)),
                            num_inliers=torch.sum(c.valid.to(torch.int32)))
