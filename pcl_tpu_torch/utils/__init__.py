"""Host utilities: logging, timing, console helpers, cloud generators."""

from pcl_tpu_torch.utils.logging import get_logger, set_verbosity
from pcl_tpu_torch.utils.timing import ScopeTime, StopWatch, EventFrequency
from pcl_tpu_torch.utils.console import (
    find_switch,
    parse_argument,
    parse_x_arguments,
    parse_file_extension_argument,
    TimeTrigger,
    Synchronizer,
    gaussian_kernel_1d,
    fit_polynomial,
    eval_polynomial,
)
from pcl_tpu_torch.utils.generate import (
    generate_cloud_uniform,
    generate_cloud_normal,
    split,
)

__all__ = [
    "get_logger", "set_verbosity", "ScopeTime", "StopWatch", "EventFrequency",
    "find_switch", "parse_argument", "parse_x_arguments",
    "parse_file_extension_argument", "TimeTrigger", "Synchronizer",
    "gaussian_kernel_1d", "fit_polynomial", "eval_polynomial",
    "generate_cloud_uniform", "generate_cloud_normal", "split",
]
