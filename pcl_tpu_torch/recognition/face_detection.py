"""Random-forest detection on depth images (PCL's recognition/
face_detection: face_detector_data_provider.h, rf_face_detector_trainer.h).

Counterpart of ``pcl_tpu/recognition/face_detection.py``, numpy host code on
``ml.trees`` copied as it is (ROADMAP C62): the same seed gives the same
stencils, forest and detections. A feature is the difference of the mean
depths of two sub-rectangles of a window, from integral images, for every
window at once; the forest scores a stride grid of windows; greedy
suppression keeps the detections.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from pcl_tpu_torch.ml.trees import RandomForest, train_random_forest


class FaceDetector(NamedTuple):
    forest: RandomForest
    stencils: np.ndarray       # [F,8] (y0a,x0a,y1a,x1a, y0b,x0b,y1b,x1b)
    patch: int                 # window size in pixels


class Detection(NamedTuple):
    y: int
    x: int
    size: int
    score: float


def _integral(img: np.ndarray) -> np.ndarray:
    ii = np.cumsum(np.cumsum(img, axis=0), axis=1)
    return np.pad(ii, ((1, 0), (1, 0)))


def _rect_sum(ii: np.ndarray, ys, xs, y0, x0, y1, x1):
    """Sum of img[y0:y1, x0:x1] for every window origin (ys, xs) via the
    integral image — vectorized over windows."""
    return (ii[ys + y1, xs + x1] - ii[ys + y0, xs + x1]
            - ii[ys + y1, xs + x0] + ii[ys + y0, xs + x0])


def _features(depth: np.ndarray, valid: np.ndarray, ys, xs,
              stencils: np.ndarray) -> np.ndarray:
    """[W, F] region-average differences for windows at (ys, xs) — the
    reference's integral-image depth feature (face_common.h evaluation)."""
    d = np.where(valid, depth, 0.0)
    ii = _integral(d)
    iv = _integral(valid.astype(np.float64))
    out = np.empty((len(ys), len(stencils)), np.float32)
    for f, (ya, xa, yb, xb, yc, xc, yd, xd) in enumerate(stencils):
        sa = _rect_sum(ii, ys, xs, ya, xa, yb, xb)
        na = np.maximum(_rect_sum(iv, ys, xs, ya, xa, yb, xb), 1.0)
        sb = _rect_sum(ii, ys, xs, yc, xc, yd, xd)
        nb = np.maximum(_rect_sum(iv, ys, xs, yc, xc, yd, xd), 1.0)
        out[:, f] = (sa / na - sb / nb).astype(np.float32)
    return out


def _make_stencils(patch: int, n_features: int, rng) -> np.ndarray:
    st = np.empty((n_features, 8), np.int64)
    for f in range(n_features):
        for half in range(2):
            y0, y1 = np.sort(rng.integers(0, patch, 2))
            x0, x1 = np.sort(rng.integers(0, patch, 2))
            y1 = min(y1 + 1, patch)
            x1 = min(x1 + 1, patch)
            st[f, 4 * half: 4 * half + 4] = (y0, x0, y1, x1)
    return st


def train_face_detector(
    pos_patches: List[np.ndarray],
    neg_patches: List[np.ndarray],
    patch: int = 24,
    n_features: int = 48,
    n_trees: int = 10,
    depth: int = 7,
    seed: int = 0,
) -> FaceDetector:
    """Train on [patch,patch] depth patches (positives = heads). Mirrors
    rf_face_detector_trainer.h's forest training over depth features."""
    rng = np.random.default_rng(seed)
    stencils = _make_stencils(patch, n_features, rng)
    feats, labels = [], []
    for label, patches in ((1, pos_patches), (0, neg_patches)):
        for p in patches:
            p = np.asarray(p, np.float32)
            assert p.shape == (patch, patch)
            f = _features(p, p > 0, np.asarray([0]), np.asarray([0]), stencils)
            feats.append(f[0])
            labels.append(label)
    forest = train_random_forest(
        np.asarray(feats, np.float32), np.asarray(labels, np.int64),
        n_trees=n_trees, depth=depth, n_classes=2, seed=seed)
    return FaceDetector(forest=forest, stencils=stencils, patch=patch)


def detect_faces(
    detector: FaceDetector,
    depth: np.ndarray,
    stride: int = 4,
    threshold: float = 0.6,
    max_detections: int = 8,
) -> List[Detection]:
    """Sliding-window detection + greedy NMS (reference
    rf_face_detector_trainer.h detectFaces + head clustering)."""
    H, W = depth.shape
    p = detector.patch
    if H < p or W < p:
        return []
    gy = np.arange(0, H - p + 1, stride)
    gx = np.arange(0, W - p + 1, stride)
    ys, xs = np.meshgrid(gy, gx, indexing="ij")
    ys = ys.ravel()
    xs = xs.ravel()
    feats = _features(depth, depth > 0, ys, xs, detector.stencils)
    prob = detector.forest.evaluate(feats)[:, 1]
    order = np.argsort(-prob)
    out: List[Detection] = []
    for i in order:
        if prob[i] < threshold or len(out) >= max_detections:
            break
        y, x = int(ys[i]), int(xs[i])
        if any(abs(d.y - y) < p // 2 and abs(d.x - x) < p // 2 for d in out):
            continue
        out.append(Detection(y=y, x=x, size=p, score=float(prob[i])))
    return out
