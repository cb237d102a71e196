"""The port's data model and geometry: the padded ``Cloud``, transforms,
geometry, spring border ops and intersections (``range_image`` and
``casts`` are imported by module)."""

from pcl_tpu_torch.core.cloud import (
    Cloud,
    make_cloud,
    from_numpy,
    to_numpy,
    concat,
    compact,
    compact_indices,
)
from pcl_tpu_torch.core import geometry, transforms, spring, intersections

__all__ = [
    "Cloud",
    "make_cloud",
    "from_numpy",
    "to_numpy",
    "concat",
    "compact",
    "compact_indices",
    "geometry",
    "transforms",
    "spring",
    "intersections",
]
