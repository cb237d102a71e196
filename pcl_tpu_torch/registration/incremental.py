"""Incremental and meta registration: running scan-to-scan odometry.

Counterpart of ``pcl_tpu/registration/incremental.py`` (PCL's
IncrementalRegistration and MetaRegistration). Host-side accumulators
around a pairwise aligner (``icp`` unless another is given): incremental
aligns each new scan to the previous one and chains the transforms, meta
aligns each scan to the union of all scans aligned so far. The absolute
pose stays on the device in float32; ``converged`` is read back once a
pair.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pcl_tpu_torch.core.cloud import Cloud, concat
from pcl_tpu_torch.core.transforms import transform_cloud
from pcl_tpu_torch.registration.icp import icp


def _eye(cloud: Optional[Cloud]) -> torch.Tensor:
    dev = None if cloud is None else cloud.xyz.device
    return torch.eye(4, dtype=torch.float32, device=dev)


class IncrementalRegistration:
    """Chain pairwise alignments: ``abs_k = abs_{k-1} @ T(k, k-1)``."""

    def __init__(self, register: Optional[Callable] = None, **icp_kwargs):
        self._register = register or (lambda s, t: icp(s, t, **icp_kwargs))
        self._last: Optional[Cloud] = None
        self._abs = _eye(None)

    def register_cloud(self, cloud: Cloud, delta_estimate: Optional[torch.Tensor] = None
                       ) -> bool:
        """Feed the next scan; returns False if the pairwise step failed (the
        scan is then not kept)."""
        if self._last is None:
            self._last = cloud
            self._abs = _eye(cloud)
            return True
        res = self._register(cloud, self._last)
        ok = bool(res.converged)
        if ok:
            self._abs = self._abs @ res.transform
            self._last = cloud
        return ok

    @property
    def absolute_transform(self) -> torch.Tensor:
        """Pose of the last registered scan in the first scan's frame."""
        return self._abs

    def reset(self):
        self._last = None
        self._abs = _eye(None)


class MetaRegistration:
    """Align each scan against the union of all previously aligned scans;
    the model stops growing past ``max_model_points`` rows."""

    def __init__(self, register: Optional[Callable] = None,
                 max_model_points: int = 1 << 20, **icp_kwargs):
        self._register = register or (lambda s, t: icp(s, t, **icp_kwargs))
        self._model: Optional[Cloud] = None
        self._abs = _eye(None)
        self._max_model_points = max_model_points

    def register_cloud(self, cloud: Cloud) -> bool:
        if self._model is None:
            self._model = cloud
            self._abs = _eye(cloud)
            return True
        res = self._register(cloud, self._model)
        ok = bool(res.converged)
        if ok:
            self._abs = res.transform
            merged = concat(self._model, transform_cloud(res.transform, cloud))
            if merged.capacity <= self._max_model_points:
                self._model = merged
        return ok

    @property
    def model(self) -> Optional[Cloud]:
        return self._model

    @property
    def absolute_transform(self) -> torch.Tensor:
        return self._abs
