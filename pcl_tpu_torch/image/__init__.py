"""2-D image operations (counterpart of ``pcl_tpu/image``): convolution,
edge detection and morphology over ``[H, W]`` tensors.

``__all__`` is the JAX package's names less those of ``image/extractors``,
left for ROADMAP item 22a.
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

__all__ = ["convolve2d", "gaussian_kernel", "gaussian_blur", "sobel", "prewitt", "erode",
           "dilate", "canny", "canny_from_gradients"]
