"""Point-cloud features of pcl_tpu_torch (counterpart of ``pcl_tpu/features``).

``__all__`` is the names the JAX package's ``__init__`` imports, in its
order.
"""

from pcl_tpu_torch.features.normals import estimate_normals, flip_normals_towards_viewpoint
from pcl_tpu_torch.features.fpfh import estimate_fpfh, estimate_pfh
from pcl_tpu_torch.features.shot import (
    estimate_shot_interpolated, estimate_shot, estimate_shot_hard, estimate_shot_color,
    local_reference_frames,
)
from pcl_tpu_torch.features.global_desc import estimate_vfh, estimate_esf
from pcl_tpu_torch.features.local_misc import (
    spin_images_reference, principal_curvatures, boundary_estimation, spin_images,
    difference_of_normals, moment_of_inertia, MomentsResult, moment_invariants,
)
from pcl_tpu_torch.features.rsd import estimate_rsd, estimate_grsd, GRSD_BINS
from pcl_tpu_torch.features.intensity import intensity_gradient, intensity_spin, rift
from pcl_tpu_torch.features.cvfh import (
    estimate_cvfh, estimate_our_cvfh, estimate_crh, crh_align, ClusteredSignatures,
)
from pcl_tpu_torch.features.gasd import estimate_gasd, estimate_gasd_color
from pcl_tpu_torch.features.integral_normals import integral_image_normals
from pcl_tpu_torch.features.shape_context import estimate_3dsc, estimate_usc
from pcl_tpu_torch.features.rops import estimate_rops, estimate_rops_mesh
from pcl_tpu_torch.features.organized_edge import (
    organized_edge_detection, edge_label_indices, EDGELABEL_NAN_BOUNDARY, EDGELABEL_OCCLUDING,
    EDGELABEL_OCCLUDED, EDGELABEL_HIGH_CURVATURE, EDGELABEL_RGB_CANNY,
)
from pcl_tpu_torch.features.lrf import board_lrf, flare_lrf
from pcl_tpu_torch.features.persistence import feature_persistence
from pcl_tpu_torch.features.narf import (
    extract_borders, narf_interest_image, narf_keypoints, narf_descriptors,
    BorderDescription, BORDER_NONE, BORDER_OBSTACLE, BORDER_SHADOW,
)
from pcl_tpu_torch.features.color_features import (
    estimate_pfhrgb, ppfrgb_features, estimate_cppf,
)

__all__ = [
    "estimate_normals", "flip_normals_towards_viewpoint", "estimate_fpfh", "estimate_pfh",
    "estimate_shot_interpolated", "estimate_shot", "estimate_shot_hard", "estimate_shot_color",
    "local_reference_frames", "estimate_vfh", "estimate_esf", "spin_images_reference",
    "principal_curvatures", "boundary_estimation", "spin_images", "difference_of_normals",
    "moment_of_inertia", "MomentsResult", "moment_invariants", "estimate_rsd", "estimate_grsd",
    "GRSD_BINS", "intensity_gradient", "intensity_spin", "rift", "estimate_cvfh",
    "estimate_our_cvfh", "estimate_crh", "crh_align", "ClusteredSignatures", "estimate_gasd",
    "estimate_gasd_color", "integral_image_normals", "estimate_3dsc", "estimate_usc",
    "estimate_rops", "estimate_rops_mesh", "organized_edge_detection", "edge_label_indices",
    "EDGELABEL_NAN_BOUNDARY", "EDGELABEL_OCCLUDING", "EDGELABEL_OCCLUDED",
    "EDGELABEL_HIGH_CURVATURE", "EDGELABEL_RGB_CANNY", "board_lrf", "flare_lrf", "feature_persistence",
    "extract_borders", "narf_interest_image", "narf_keypoints", "narf_descriptors",
    "BorderDescription", "BORDER_NONE", "BORDER_OBSTACLE", "BORDER_SHADOW",
    "estimate_pfhrgb", "ppfrgb_features", "estimate_cppf",
]
