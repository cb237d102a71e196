"""Headless visualization — file-based viewers.

The reference's ``visualization/`` module is VTK-window based
(pcl::visualization::PCLVisualizer); a compute server has no display,
so the equivalent here is EXPORT: self-contained interactive HTML viewers
(WebGL, no external assets) for clouds and meshes, plus PNG-free ASCII
snapshot rendering for logs/CI. Covers the PCLVisualizer/CloudViewer use
case (inspect a result) in a server environment.
"""

from pcl_tpu_torch.visualization.export import (
    cloud_to_html,
    mesh_to_html,
    render_ascii,
)
from pcl_tpu_torch.visualization.plotter import (
    plot_xy_svg,
    plot_histogram_svg,
    histogram_visualizer_svg,
    range_image_to_pgm,
)
from pcl_tpu_torch.visualization.visualizer import (
    Visualizer,
    KeyboardEvent,
    PointPickingEvent,
    MouseEvent,
)
from pcl_tpu_torch.visualization.live import LiveViewer

__all__ = ["cloud_to_html", "mesh_to_html", "render_ascii", "plot_xy_svg", "plot_histogram_svg",
           "histogram_visualizer_svg", "range_image_to_pgm", "Visualizer", "KeyboardEvent",
           "PointPickingEvent", "MouseEvent", "LiveViewer"]
