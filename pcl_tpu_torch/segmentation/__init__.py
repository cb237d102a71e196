"""Segmentation (counterpart of ``pcl_tpu/segmentation``): cluster
extraction, region growing, sample-consensus segmentation, supervoxels,
graph cuts, organized segmentation, LCCP/CPC, seeded hue and the random
walker. ``__all__`` is the JAX package's list."""

from pcl_tpu_torch.segmentation.clustering import (
    euclidean_clusters,
    labels_to_cluster_sizes,
    propagate_labels,
)
from pcl_tpu_torch.segmentation.region_growing import region_growing
from pcl_tpu_torch.segmentation.sac_segmentation import sac_segmentation, segment_differences
from pcl_tpu_torch.segmentation.supervoxel import supervoxel_clustering, SupervoxelResult
from pcl_tpu_torch.segmentation.graphcut import (
    min_cut_segmentation,
    grab_cut,
    max_flow_binary_labels,
)
from pcl_tpu_torch.segmentation.organized import (
    organized_connected_components,
    organized_multi_plane_segmentation,
    extract_polygonal_prism,
    PlanarRegion,
)
from pcl_tpu_torch.segmentation.advanced import (
    lccp_segmentation,
    cpc_segmentation,
    seeded_hue_segmentation,
    random_walker,
    UnaryClassifier,
)

__all__ = ["euclidean_clusters", "labels_to_cluster_sizes", "propagate_labels",
           "region_growing", "sac_segmentation", "segment_differences",
           "supervoxel_clustering", "SupervoxelResult", "min_cut_segmentation", "grab_cut",
           "max_flow_binary_labels", "organized_connected_components",
           "organized_multi_plane_segmentation", "extract_polygonal_prism", "PlanarRegion",
           "lccp_segmentation", "cpc_segmentation", "seeded_hue_segmentation", "random_walker",
           "UnaryClassifier"]
