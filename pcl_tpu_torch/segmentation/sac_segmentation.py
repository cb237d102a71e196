"""SAC segmentation and cloud differencing.

Counterpart of ``pcl_tpu/segmentation/sac_segmentation.py``:
``sac_segmentation`` fits a model robustly and returns its inliers and
coefficients (PCL's SACSegmentation, and SACSegmentationFromNormals for
models that need normals); ``segment_differences`` keeps the points of one
cloud farther than a threshold from every point of another (1-NN through
kernel B1 on CUDA tensors).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import ATTR_NORMAL, Cloud
from pcl_tpu_torch.sac import SacResult, ransac
from pcl_tpu_torch.sac.models import SacModel
from pcl_tpu_torch.search import bruteforce


def sac_segmentation(
    cloud: Cloud,
    model: SacModel,
    distance_threshold: float,
    *,
    gen: Optional[torch.Generator] = None,
    n_hypotheses: int = 1024,
    method: str = "ransac",
    refine: bool = True,
) -> SacResult:
    """Fit ``model`` to the cloud; ``result.inliers`` is the segment."""
    normals = cloud.attrs.get(ATTR_NORMAL) if model.needs_normals else None
    if model.needs_normals and normals is None:
        raise ValueError(f"{type(model).__name__} requires normals on the cloud")
    return ransac(model, cloud.xyz, cloud.mask, distance_threshold, gen=gen,
                  n_hypotheses=n_hypotheses, method=method, refine=refine, normals=normals)


def segment_differences(a: Cloud, b: Cloud, distance_threshold: float) -> Cloud:
    """The points of ``a`` with no point of ``b`` within the threshold."""
    _, d2 = bruteforce.nn1(b.xyz, b.mask, a.xyz)
    return a.with_mask(d2 > float(np.float32(distance_threshold) ** 2))
