"""The benchmark of pcl_tpu_torch on the GPU: ``python3 benchmark/run.py --help``."""
