"""Machine learning (counterpart of ``pcl_tpu/ml``): k-means, the SVMs with
Platt scaling and libsvm model files, decision trees, ferns and random
forests, and the dense CRF on the permutohedral lattice. k-means' sampler
and core are ``ml.kmeans.kmeans_init_indices`` and ``kmeans_core``; the RBF
primal SVM's are ``ml.svm.svm_basis_indices`` and ``svm_train_core``.
``__all__`` is the JAX package's, in its order."""

from pcl_tpu_torch.ml.kmeans import kmeans
from pcl_tpu_torch.ml.svm_prob import (
    PlattScaling,
    platt_calibrate,
    platt_probability,
    svm_train_probability,
    svm_predict_probability,
    svm_cross_validation,
)
from pcl_tpu_torch.ml.svm import (
    SVMModel,
    svm_train,
    svm_classify,
    svm_train_dual,
    svm_classify_dual,
)
from pcl_tpu_torch.ml.svm_io import load_libsvm_model, save_libsvm_model, load_libsvm_probability
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
from pcl_tpu_torch.ml.densecrf import DenseCRF

__all__ = ["kmeans", "PlattScaling", "platt_calibrate", "platt_probability",
           "svm_train_probability", "svm_predict_probability", "svm_cross_validation",
           "SVMModel", "svm_train", "svm_classify", "svm_train_dual", "svm_classify_dual",
           "load_libsvm_model", "save_libsvm_model", "load_libsvm_probability", "Fern",
           "train_fern", "DecisionTree", "train_decision_tree", "RandomForest",
           "train_random_forest", "save_model", "load_model", "DenseCRF"]
