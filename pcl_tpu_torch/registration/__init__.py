"""Registration: what is ported so far, under the JAX package's names."""

from pcl_tpu_torch.registration.correspondence import (
    Correspondences,
    correspondence_normal_shooting,
    determine_correspondences,
    determine_reciprocal_correspondences,
)
from pcl_tpu_torch.registration.estimation import (
    estimate_point_to_plane,
    estimate_svd,
    estimate_symmetric_point_to_plane,
    point_to_plane_system,
)
from pcl_tpu_torch.registration.gicp import GICPResult, gicp, regularized_covariances
from pcl_tpu_torch.registration.graph import (
    PoseGraphResult,
    build_edges_from_correspondences,
    elch_distribute,
    lum,
)
from pcl_tpu_torch.registration.ia import IAResult, feature_knn, prerejective_ransac, sac_ia
from pcl_tpu_torch.registration.icp import ICPResult, align, fitness_score, icp
from pcl_tpu_torch.registration.ndt import NDTResult, build_grid, ndt
from pcl_tpu_torch.registration.trajectory import (
    ATEResult,
    RPEResult,
    make_drift_sequence,
    odometry_sequence,
    trajectory_ate,
    trajectory_rpe,
    umeyama_se3,
)
from pcl_tpu_torch.registration.validation import ValidationResult, validate_euclidean
from pcl_tpu_torch.registration import rejection

__all__ = [
    "Correspondences",
    "determine_correspondences",
    "determine_reciprocal_correspondences",
    "correspondence_normal_shooting",
    "estimate_svd",
    "estimate_point_to_plane",
    "estimate_symmetric_point_to_plane",
    "point_to_plane_system",
    "ICPResult", "icp", "align", "fitness_score",
    "NDTResult", "ndt", "build_grid",
    "GICPResult", "gicp", "regularized_covariances",
    "ATEResult", "RPEResult", "trajectory_ate", "trajectory_rpe",
    "odometry_sequence", "make_drift_sequence", "umeyama_se3",
    "IAResult", "sac_ia", "prerejective_ransac", "feature_knn",
    "PoseGraphResult", "lum", "elch_distribute",
    "build_edges_from_correspondences",
    "ValidationResult", "validate_euclidean", "rejection",
]
