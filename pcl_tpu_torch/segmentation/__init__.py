"""Segmentation of pcl_tpu_torch (counterpart of ``pcl_tpu/segmentation``):
so far the sample-consensus segmentation and cloud differencing."""

from pcl_tpu_torch.segmentation.sac_segmentation import sac_segmentation, segment_differences

__all__ = ["sac_segmentation", "segment_differences"]
