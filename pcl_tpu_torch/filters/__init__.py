"""Point-cloud filters, under the JAX package's names (``pcl_tpu.filters``):
the same ``__all__``, in the same order."""

from pcl_tpu_torch.filters.voxel_grid import voxel_downsample, uniform_sample
from pcl_tpu_torch.filters.passthrough import pass_through, crop_box, function_filter, clip_plane
from pcl_tpu_torch.filters.outliers import (
    statistical_outlier_removal,
    radius_outlier_removal,
    radius_outlier_keep,
)
from pcl_tpu_torch.filters.sampling import (
    random_sample,
    farthest_point_sample,
    normal_space_sample,
)
from pcl_tpu_torch.filters.extras import (
    frustum_culling,
    project_inliers,
    model_outlier_removal,
    grid_minimum,
    local_maximum,
    shadow_points,
    bilateral_filter,
    normal_refinement,
    approximate_voxel_grid,
    extract_indices,
)
from pcl_tpu_torch.filters.morphological import (
    morphological_filter,
    progressive_morphological_filter,
)
from pcl_tpu_torch.filters.convolution import (
    convolution_3d,
    convolution_rows,
    convolution_cols,
    pyramid,
    fast_bilateral,
    covariance_sampling,
    sampling_surface_normal,
)
from pcl_tpu_torch.filters.crop_hull import (
    crop_hull,
    conditional_removal,
    median_filter,
    field, gt, lt, ge, le, and_, or_, not_,
)

__all__ = [
    "voxel_downsample",
    "uniform_sample",
    "pass_through",
    "crop_box",
    "function_filter",
    "clip_plane",
    "statistical_outlier_removal",
    "radius_outlier_removal",
    "radius_outlier_keep",
    "random_sample",
    "farthest_point_sample",
    "normal_space_sample",
    "frustum_culling",
    "project_inliers",
    "model_outlier_removal",
    "grid_minimum",
    "local_maximum",
    "shadow_points",
    "bilateral_filter",
    "normal_refinement",
    "approximate_voxel_grid",
    "extract_indices",
    "morphological_filter",
    "progressive_morphological_filter",
    "crop_hull",
    "conditional_removal",
    "median_filter",
    "convolution_3d",
    "convolution_rows",
    "convolution_cols",
    "pyramid",
    "fast_bilateral",
    "covariance_sampling",
    "sampling_surface_normal",
]
