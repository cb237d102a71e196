"""Machine learning (counterpart of ``pcl_tpu/ml``): k-means and the
decision trees, ferns and random forests. k-means' sampler and core are
``ml.kmeans.kmeans_init_indices`` and ``kmeans_core``. ``__all__`` is the
JAX package's names less those of ``svm``, ``svm_prob``, ``svm_io`` and
``densecrf``, left for ROADMAP item 21b."""

from pcl_tpu_torch.ml.kmeans import kmeans
from pcl_tpu_torch.ml.trees import (
    Fern,
    train_fern,
    DecisionTree,
    train_decision_tree,
    RandomForest,
    train_random_forest,
    save_model,
    load_model,
)

__all__ = ["kmeans", "Fern", "train_fern", "DecisionTree", "train_decision_tree", "RandomForest",
           "train_random_forest", "save_model", "load_model"]
