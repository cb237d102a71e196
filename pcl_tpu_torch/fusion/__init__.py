"""Dense depth fusion, the KinectFusion pipeline (counterpart of
``pcl_tpu/fusion``): TSDF integration, raycast, projective point-to-plane ICP
odometry, the world model and volume checkpoints."""

from pcl_tpu_torch.fusion.kinfu import KinfuState, kinfu_init, kinfu_reset, kinfu_step
from pcl_tpu_torch.fusion.tsdf import (
    Intrinsics,
    TSDFVolume,
    depth_to_vertex_map,
    extract_surface_points,
    integrate,
    make_volume,
    raycast,
    vertex_map_normals,
)
from pcl_tpu_torch.fusion.world_model import WorldModel, load_tsdf, save_tsdf

__all__ = [
    "Intrinsics", "TSDFVolume", "make_volume", "integrate", "raycast",
    "extract_surface_points", "depth_to_vertex_map", "vertex_map_normals",
    "KinfuState", "kinfu_init", "kinfu_step", "kinfu_reset",
    "WorldModel", "save_tsdf", "load_tsdf",
]
