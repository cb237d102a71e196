"""People detection (counterpart of ``pcl_tpu/people``): HOG features, the
HOG and linear-SVM person classifier, and the ground-based people detector.
``__all__`` is the JAX package's, in its order."""

from pcl_tpu_torch.people.hog import hog_features
from pcl_tpu_torch.people.detector import GroundBasedPeopleDetector
from pcl_tpu_torch.people.classifier import PersonClassifier

__all__ = ["hog_features", "GroundBasedPeopleDetector", "PersonClassifier"]
