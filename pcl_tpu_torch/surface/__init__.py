"""Surface processing (counterpart of ``pcl_tpu/surface``): MLS smoothing
and upsampling, implicit reconstructions (Hoppe, Poisson, RBF), greedy
projection triangulation, ear clipping, grid projection, surfel smoothing,
bilateral upsampling, texture mapping, hulls, mesh smoothing and B-splines.
``__all__`` is the JAX package's list."""

from pcl_tpu_torch.surface.mls import moving_least_squares
from pcl_tpu_torch.surface.reconstruction import (
    hoppe_signed_distance,
    surface_nets,
    reconstruct_hoppe,
    organized_fast_mesh,
)
from pcl_tpu_torch.surface.hulls import (
    convex_hull,
    concave_hull,
)
from pcl_tpu_torch.surface.poisson import poisson_reconstruction
from pcl_tpu_torch.surface.triangulation import (
    greedy_projection_triangulation,
    ear_clipping,
    triangulate_mesh_polygons,
)
from pcl_tpu_torch.surface.processing import (
    grid_projection,
    surfel_smoothing,
    bilateral_upsampling,
    texture_mapping,
)
from pcl_tpu_torch.surface.mls_upsampling import (
    mls_project,
    mls_distinct_cloud,
    mls_upsample_local_plane,
    mls_upsample_random_density,
    mls_upsample_voxel_dilation,
)
from pcl_tpu_torch.surface.rbf import marching_cubes_rbf
from pcl_tpu_torch.surface.mesh_smoothing import (
    laplacian_smooth,
    taubin_smooth,
    subdivide_linear,
    decimate_cluster,
    boundary_vertices,
)
from pcl_tpu_torch.surface.bspline import (
    BSplineSurface,
    BSplineCurve2D,
    fit_bspline_surface,
    eval_bspline_surface,
    fit_bspline_curve2d,
    fit_bspline_curve3d,
    eval_bspline_curve3d,
    create_mesh_indices,
    convert_surface_to_mesh,
    eval_bspline_curve2d,
    fit_bspline_surface_iterated,
    fit_trimmed_bspline_surface,
    eval_trimmed_bspline_surface,
    trimmed_surface_contains,
)

__all__ = ["moving_least_squares", "hoppe_signed_distance", "surface_nets", "reconstruct_hoppe",
           "organized_fast_mesh", "convex_hull", "concave_hull", "poisson_reconstruction",
           "greedy_projection_triangulation", "ear_clipping", "triangulate_mesh_polygons",
           "grid_projection", "surfel_smoothing", "bilateral_upsampling", "texture_mapping",
           "mls_project", "mls_distinct_cloud", "mls_upsample_local_plane",
           "mls_upsample_random_density", "mls_upsample_voxel_dilation", "marching_cubes_rbf",
           "laplacian_smooth", "taubin_smooth", "subdivide_linear", "decimate_cluster",
           "boundary_vertices", "BSplineSurface", "BSplineCurve2D", "fit_bspline_surface",
           "eval_bspline_surface", "fit_bspline_curve2d", "fit_bspline_curve3d",
           "eval_bspline_curve3d", "create_mesh_indices", "convert_surface_to_mesh",
           "eval_bspline_curve2d", "fit_bspline_surface_iterated", "fit_trimmed_bspline_surface",
           "eval_trimmed_bspline_surface", "trimmed_surface_contains"]
