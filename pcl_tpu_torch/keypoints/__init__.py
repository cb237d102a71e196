"""Keypoint detectors, under the JAX package's names; ``__all__`` is the
JAX package's list, in its order."""

from pcl_tpu_torch.keypoints.iss import iss3d_keypoints
from pcl_tpu_torch.keypoints.harris import harris3d_keypoints
from pcl_tpu_torch.keypoints.sift import sift_keypoints
from pcl_tpu_torch.keypoints.susan import susan_keypoints
from pcl_tpu_torch.keypoints.corners2d import (
    agast_keypoints,
    brisk_keypoints,
    brisk_descriptor,
    trajkovic_keypoints,
    agast_score,
    trajkovic_score,
)
from pcl_tpu_torch.keypoints.smoothed import smoothed_surfaces_keypoints

__all__ = ["iss3d_keypoints", "harris3d_keypoints", "sift_keypoints", "susan_keypoints",
           "agast_keypoints", "brisk_keypoints", "brisk_descriptor", "trajkovic_keypoints",
           "agast_score", "trajkovic_score", "smoothed_surfaces_keypoints"]
