"""Registration, under the JAX package's names (``pcl_tpu.registration``):
the same ``__all__``, in the same order."""

from pcl_tpu_torch.registration.correspondence import (
    Correspondences,
    determine_correspondences,
    determine_reciprocal_correspondences,
    correspondence_normal_shooting,
)
from pcl_tpu_torch.registration.estimation import (
    estimate_svd,
    estimate_point_to_plane,
    estimate_symmetric_point_to_plane,
    point_to_plane_system,
)
from pcl_tpu_torch.registration.icp import ICPResult, icp, align, fitness_score
from pcl_tpu_torch.registration.ndt import NDTResult, ndt, build_grid
from pcl_tpu_torch.registration.ndt2d import NDT2DResult, ndt_2d, build_grid_2d
from pcl_tpu_torch.registration.gicp import GICPResult, gicp, regularized_covariances
from pcl_tpu_torch.registration.ia import (
    IAResult, sac_ia, prerejective_ransac, feature_knn,
)
from pcl_tpu_torch.registration.graph import (
    PoseGraphResult, lum, elch_distribute, build_edges_from_correspondences,
)
from pcl_tpu_torch.registration.incremental import IncrementalRegistration, MetaRegistration
from pcl_tpu_torch.registration.trajectory import (
    ATEResult, RPEResult, trajectory_ate, trajectory_rpe,
    odometry_sequence, make_drift_sequence, umeyama_se3,
)

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
    "NDT2DResult", "ndt_2d", "build_grid_2d",
    "GICPResult", "gicp", "regularized_covariances",
    "IAResult", "sac_ia", "prerejective_ransac", "feature_knn",
    "PoseGraphResult", "lum", "elch_distribute",
    "build_edges_from_correspondences",
    "IncrementalRegistration", "MetaRegistration",
    "ATEResult", "RPEResult", "trajectory_ate", "trajectory_rpe",
    "odometry_sequence", "make_drift_sequence", "umeyama_se3",
]

from pcl_tpu_torch.registration.estimation import (  # noqa: E402
    estimate_dual_quaternion, estimate_2d, estimate_3point, estimate_lm,
    warp_rigid_6d, warp_rigid_3d, warp_translation,
)
from pcl_tpu_torch.registration.fpcs import (  # noqa: E402
    fpcs_align, kfpcs_align, fpcs4_align, fpcs4_align_host,
)
from pcl_tpu_torch.registration.variants import icp_nl, joint_icp  # noqa: E402
from pcl_tpu_torch.registration.validation import (  # noqa: E402
    ValidationResult, validate_euclidean,
)
from pcl_tpu_torch.registration.pyramid import (  # noqa: E402
    FeaturePyramid, build_pyramid, compare_pyramids,
)
from pcl_tpu_torch.registration.ppf import PPFResult, ppf_register  # noqa: E402
from pcl_tpu_torch.registration import rejection  # noqa: E402

__all__ += [
    "estimate_dual_quaternion", "estimate_2d", "estimate_3point", "estimate_lm",
    "warp_rigid_6d", "warp_rigid_3d", "warp_translation",
    "fpcs_align", "kfpcs_align", "fpcs4_align", "fpcs4_align_host",
    "icp_nl", "joint_icp",
    "ValidationResult", "validate_euclidean",
    "FeaturePyramid", "build_pyramid", "compare_pyramids",
    "PPFResult", "ppf_register", "rejection",
]
