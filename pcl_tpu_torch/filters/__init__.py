"""Point-cloud filters of pcl_tpu_torch (counterpart of ``pcl_tpu/filters``)."""

from pcl_tpu_torch.filters.convolution import fast_bilateral
from pcl_tpu_torch.filters.voxel_grid import uniform_sample, voxel_downsample

__all__ = ["voxel_downsample", "uniform_sample", "fast_bilateral"]
