"""Object recognition (counterpart of ``pcl_tpu/recognition``, PCL's
recognition/): correspondence grouping, hypothesis verification, LINEMOD,
the implicit shape model, ObjRecRANSAC, the global pipeline and the
depth-patch forest detector. ``__all__`` is the JAX package's names, in its
order."""

from pcl_tpu_torch.recognition.grouping import (
    geometric_consistency_grouping,
    hough3d_grouping,
    refine_grouping_sac,
    GroupingResult,
)
from pcl_tpu_torch.recognition.verification import greedy_hypothesis_verification
from pcl_tpu_torch.recognition.linemod import (
    color_gradient_quantized,
    surface_normal_quantized,
    spread_quantized_map,
    extract_template,
    detect_templates,
    line_rgbd_detect,
    build_modality_maps,
    LinemodTemplate,
    LinemodDetection,
)
from pcl_tpu_torch.recognition.ism import (
    ISMModel,
    train_ism,
    find_objects,
    find_strongest_peaks,
    save_ism_model,
    load_ism_model,
    simplify_cloud,
    align_y_with_normal,
)
from pcl_tpu_torch.recognition.orr import (
    trimmed_icp,
    obj_rec_ransac,
    distance_map,
    TrimmedICPResult,
)
from pcl_tpu_torch.recognition.orr import (
    mask_difference,
    mask_erode,
    sample_oriented_point_pairs,
    pair_feature_hash_table,
)
from pcl_tpu_torch.recognition.global_pipeline import (
    GlobalModelDatabase,
    GlobalRecognition,
    train_global_database,
    recognize_clusters,
    segment_scene_clusters,
    render_views,
)
from pcl_tpu_torch.recognition.linemod_io import save_templates, load_templates

__all__ = [
    "geometric_consistency_grouping", "hough3d_grouping", "refine_grouping_sac",
    "GroupingResult", "greedy_hypothesis_verification", "color_gradient_quantized",
    "surface_normal_quantized", "spread_quantized_map", "extract_template", "detect_templates",
    "line_rgbd_detect", "build_modality_maps", "LinemodTemplate", "LinemodDetection",
    "ISMModel", "train_ism", "find_objects", "find_strongest_peaks", "save_ism_model",
    "load_ism_model", "simplify_cloud", "align_y_with_normal", "trimmed_icp", "obj_rec_ransac",
    "distance_map", "TrimmedICPResult", "mask_difference", "mask_erode",
    "sample_oriented_point_pairs", "pair_feature_hash_table", "GlobalModelDatabase",
    "GlobalRecognition", "train_global_database", "recognize_clusters",
    "segment_scene_clusters", "render_views", "save_templates", "load_templates",
]
