"""Segmentation of pcl_tpu_torch (counterpart of ``pcl_tpu/segmentation``):
so far the sample-consensus segmentation, cloud differencing, Euclidean
clusters and region growing."""

from pcl_tpu_torch.segmentation.clustering import (
    euclidean_clusters,
    labels_to_cluster_sizes,
    propagate_labels,
)
from pcl_tpu_torch.segmentation.region_growing import region_growing
from pcl_tpu_torch.segmentation.sac_segmentation import sac_segmentation, segment_differences

__all__ = ["euclidean_clusters", "labels_to_cluster_sizes", "propagate_labels",
           "region_growing", "sac_segmentation", "segment_differences"]
