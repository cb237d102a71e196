"""pcl_tpu_torch — the PyTorch/CUDA port of pcl_tpu.

Module paths mirror ``pcl_tpu`` so that each function's counterpart is easy to
find; the JAX package stays the reference and this package imports nothing of
it. Functions take tensors and run on the device the tensors live on; the
constructors that pick a device (``make_cloud``, ``from_numpy``) default to
CUDA. The kernels that replace the JAX package's Pallas kernels are written by
hand for Hopper under ``csrc/`` and built on first use (``ops/_build.py``).

All arithmetic is float32. Matrix products and convolutions run in full
float32, never TF32: the reference sets its matmul precision to "highest"
(``pcl_tpu/__init__.py``), and small-K geometry loses ~3 digits in TF32.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
