"""Hand-written CUDA kernels of pcl_tpu_torch and their plain PyTorch versions."""
