"""Keypoint detectors, under the JAX package's names (ported so far: ISS)."""

from pcl_tpu_torch.keypoints.iss import iss3d_keypoints

__all__ = ["iss3d_keypoints"]
