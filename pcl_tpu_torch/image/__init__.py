"""2-D image operations (counterpart of ``pcl_tpu/image``): convolution,
edge detection and morphology over ``[H, W]`` tensors, and the images that
PCL's extractors pull out of organized clouds.

``__all__`` is the names the JAX package's ``__init__`` imports, in its
order.
"""

from pcl_tpu_torch.image.ops import (
    convolve2d,
    gaussian_kernel,
    gaussian_blur,
    sobel,
    prewitt,
    erode,
    dilate,
    canny,
    canny_from_gradients,
)
from pcl_tpu_torch.image.extractors import (
    extract_normal_image,
    extract_rgb_image,
    extract_label_image,
    extract_z_image,
    extract_curvature_image,
    extract_intensity_image,
    bearing_angle_image,
)

__all__ = ["convolve2d", "gaussian_kernel", "gaussian_blur", "sobel", "prewitt", "erode",
           "dilate", "canny", "canny_from_gradients", "extract_normal_image",
           "extract_rgb_image", "extract_label_image", "extract_z_image",
           "extract_curvature_image", "extract_intensity_image", "bearing_angle_image"]
