"""Octree: a linear (morton-order) octree over fixed-depth voxel keys.

Counterpart of ``pcl_tpu/octree``: a sorted array of bit-interleaved voxel
keys, on which leaf iteration, occupancy, change detection, level-k
traversal and box search are sorts, binary searches and segment sums.
"""

from pcl_tpu_torch.octree.linear import (
    LinearOctree,
    build,
    morton_encode,
    morton_decode,
    voxel_search,
    is_voxel_occupied,
    leaf_centroids,
    change_detection,
    box_search,
    at_depth,
)
from pcl_tpu_torch.octree.ray import ray_intersected_voxels, approx_nearest_search
from pcl_tpu_torch.octree.iterators import (
    OctreeNode,
    leaf_iterator,
    depth_first_iterator,
    breadth_first_iterator,
    fixed_depth_iterator,
    leaf_breadth_first_iterator,
    node_counts_per_depth,
)
from pcl_tpu_torch.octree.containers import (
    adjacency,
    OccupancyGrid,
    occupancy_from_tree,
    is_occupied,
    set_occupied,
)
