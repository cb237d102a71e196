"""Stereo matching (counterpart of ``pcl_tpu/stereo``): block matching and
adaptive-cost scanline optimization over a cost volume, disparity-to-cloud
conversion and digital elevation maps. Like the JAX package's, the module
defines no ``__all__``; it imports the same public names.
"""

from pcl_tpu_torch.stereo.matching import (
    block_matching,
    disparity_to_cloud,
)
from pcl_tpu_torch.stereo.advanced import (
    adaptive_cost_so_matching,
    disparity_to_dem,
)
