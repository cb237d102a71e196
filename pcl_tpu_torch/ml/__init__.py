"""Machine learning (counterpart of ``pcl_tpu/ml``): so far k-means, which
``segmentation.UnaryClassifier`` trains with (ROADMAP item 21 ports the
rest). Its sampler and core are ``ml.kmeans.kmeans_init_indices`` and
``kmeans_core``."""

from pcl_tpu_torch.ml.kmeans import kmeans

__all__ = ["kmeans"]
