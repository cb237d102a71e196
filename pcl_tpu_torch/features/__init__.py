"""Point-cloud features of pcl_tpu_torch (counterpart of ``pcl_tpu/features``)."""

from pcl_tpu_torch.features.fpfh import estimate_fpfh, estimate_pfh
from pcl_tpu_torch.features.integral_normals import integral_image_normals
from pcl_tpu_torch.features.normals import estimate_normals, flip_normals_towards_viewpoint

__all__ = ["estimate_normals", "flip_normals_towards_viewpoint", "estimate_fpfh", "estimate_pfh",
           "integral_image_normals"]
