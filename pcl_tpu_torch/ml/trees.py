"""Decision trees and random ferns (PCL's ml/dt and ml/ferns trainers and
evaluators).

Counterpart of ``pcl_tpu/ml/trees.py``, which is numpy host code (ROADMAP
C62): a copy, so that the same seeds grow the same trees bit for bit and each
package's model files load in the other.

- ``Fern``: D (feature, threshold) pairs and a ``2^D`` leaf histogram; the
  trainer scores every candidate split of a bit in one pass.
- ``DecisionTree``: a complete binary tree of depth D as arrays (feature and
  threshold per internal node in heap order, leaf class probabilities),
  grown level by level, every node of a level split in one histogram pass.
- ``RandomForest``: bagged trees, posteriors averaged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def _entropy(counts: np.ndarray) -> np.ndarray:
    p = counts / np.maximum(counts.sum(-1, keepdims=True), 1e-9)
    return -(p * np.log(p + 1e-12)).sum(-1)


@dataclass
class Fern:
    features: np.ndarray    # [D] int32 feature indices
    thresholds: np.ndarray  # [D] f32
    leaf_probs: np.ndarray  # [2^D, C]

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        D = len(self.features)
        bits = (x[:, self.features] > self.thresholds[None, :]).astype(np.int64)
        # training folds bits in MSB-first (code = code*2 + bit) order
        code = (bits * (1 << np.arange(D - 1, -1, -1))[None, :]).sum(1)
        return self.leaf_probs[code]

    def classify(self, x: np.ndarray) -> np.ndarray:
        return self.evaluate(x).argmax(1).astype(np.int32)


def train_fern(
    x: np.ndarray,
    y: np.ndarray,
    depth: int = 8,
    n_classes: Optional[int] = None,
    n_candidates: int = 32,
    seed: int = 0,
) -> Fern:
    """Greedy per-bit selection by information gain over random
    (feature, threshold) candidates (fern_trainer.hpp createThresholds +
    gain loop, all candidates evaluated in one batch here)."""
    rng = np.random.default_rng(seed)
    n, f = x.shape
    C = int(n_classes or (y.max() + 1))
    feats, thrs = [], []
    code = np.zeros(n, np.int64)
    for d in range(depth):
        cf = rng.integers(0, f, n_candidates)
        ct = x[rng.integers(0, n, n_candidates), cf] + rng.normal(
            scale=1e-6, size=n_candidates
        )
        bits = x[:, cf] > ct[None, :]  # [n, cand]
        # gain: entropy of (code*2+bit, y) partition per candidate
        best_gain, best_j = -1.0, 0
        for j in range(n_candidates):
            new_code = code * 2 + bits[:, j]
            hist = np.zeros((1 << (d + 1), C))
            np.add.at(hist, (new_code, y), 1.0)
            w = hist.sum(1)
            cond_ent = (w * _entropy(hist)).sum() / max(w.sum(), 1e-9)
            gain = -cond_ent
            if gain > best_gain:
                best_gain, best_j = gain, j
        feats.append(cf[best_j])
        thrs.append(ct[best_j])
        code = code * 2 + bits[:, best_j]
    hist = np.full((1 << depth, C), 1.0)  # +1 Laplace smoothing
    np.add.at(hist, (code, y), 1.0)
    probs = hist / hist.sum(1, keepdims=True)
    return Fern(
        np.asarray(feats, np.int32), np.asarray(thrs, np.float32), probs
    )


@dataclass
class DecisionTree:
    feature: np.ndarray    # [2^D - 1] int32 (internal nodes, heap order)
    threshold: np.ndarray  # [2^D - 1] f32
    leaf_probs: np.ndarray  # [2^D, C]
    depth: int

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        node = np.zeros(len(x), np.int64)
        for _ in range(self.depth):
            f = self.feature[node]
            go_right = x[np.arange(len(x)), f] > self.threshold[node]
            node = node * 2 + 1 + go_right
        leaf = node - (len(self.feature))  # nodes before leaf level
        return self.leaf_probs[leaf]

    def classify(self, x: np.ndarray) -> np.ndarray:
        return self.evaluate(x).argmax(1).astype(np.int32)


def train_decision_tree(
    x: np.ndarray,
    y: np.ndarray,
    depth: int = 6,
    n_classes: Optional[int] = None,
    n_candidates: int = 24,
    seed: int = 0,
) -> DecisionTree:
    """Level-synchronous growth of a complete tree: every node of a level
    picks its best split from shared random candidates in one vectorized
    histogram pass (decision_tree_trainer.hpp trainDecisionTreeNode,
    restructured from recursive to breadth-parallel)."""
    rng = np.random.default_rng(seed)
    n, f = x.shape
    C = int(n_classes or (y.max() + 1))
    n_internal = (1 << depth) - 1
    feature = np.zeros(n_internal, np.int32)
    threshold = np.zeros(n_internal, np.float32)
    node_of = np.zeros(n, np.int64)  # current node per example (heap index)

    for level in range(depth):
        first = (1 << level) - 1
        cf = rng.integers(0, f, n_candidates)
        ct = x[rng.integers(0, n, n_candidates), cf]
        bits = x[:, cf] > ct[None, :]  # [n, cand]
        # per (node, candidate) conditional entropy via bincount
        rel = node_of - first  # node index within level
        n_nodes = 1 << level
        best = np.full(n_nodes, -np.inf)
        for j in range(n_candidates):
            key = (rel * 2 + bits[:, j]) * C + y
            hist = np.bincount(key, minlength=n_nodes * 2 * C).reshape(
                n_nodes * 2, C
            )
            w = hist.sum(1)
            ent = _entropy(hist)
            cond = (w * ent).reshape(n_nodes, 2).sum(1) / np.maximum(
                w.reshape(n_nodes, 2).sum(1), 1e-9
            )
            gain = -cond
            upd = gain > best
            best = np.where(upd, gain, best)
            feature[first : first + n_nodes][upd] = cf[j]
            threshold[first : first + n_nodes][upd] = ct[j]
        go_right = (
            x[np.arange(n), feature[node_of]] > threshold[node_of]
        )
        node_of = node_of * 2 + 1 + go_right

    leaf = node_of - n_internal
    hist = np.full((1 << depth, C), 1.0)
    np.add.at(hist, (leaf, y), 1.0)
    probs = hist / hist.sum(1, keepdims=True)
    return DecisionTree(feature, threshold, probs, depth)


@dataclass
class RandomForest:
    trees: list

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        return np.mean([t.evaluate(x) for t in self.trees], axis=0)

    def classify(self, x: np.ndarray) -> np.ndarray:
        return self.evaluate(x).argmax(1).astype(np.int32)


def train_random_forest(
    x: np.ndarray,
    y: np.ndarray,
    n_trees: int = 8,
    depth: int = 6,
    n_classes: Optional[int] = None,
    seed: int = 0,
) -> RandomForest:
    rng = np.random.default_rng(seed)
    trees = []
    for t in range(n_trees):
        bag = rng.integers(0, len(x), len(x))
        trees.append(
            train_decision_tree(
                x[bag], y[bag], depth=depth, n_classes=n_classes, seed=seed + t
            )
        )
    return RandomForest(trees)


# ---------------------------------------------------------------------------
# Model persistence (the reference's DecisionForest/Fern trainers serialize
# models via their own iostream operators, ml/include/pcl/ml/dt/
# decision_forest.h / ferns/fern.h; here a portable .npz container)
# ---------------------------------------------------------------------------

def save_model(path: str, model) -> None:
    """Serialize a Fern / DecisionTree / RandomForest to one .npz file."""
    if isinstance(model, Fern):
        np.savez(path, kind="fern", features=model.features,
                 thresholds=model.thresholds, leaf_probs=model.leaf_probs)
    elif isinstance(model, DecisionTree):
        np.savez(path, kind="tree", feature=model.feature,
                 threshold=model.threshold, leaf_probs=model.leaf_probs,
                 depth=np.int64(model.depth))
    elif isinstance(model, RandomForest):
        arrs = {"kind": "forest", "n_trees": np.int64(len(model.trees))}
        for i, t in enumerate(model.trees):
            arrs[f"f{i}"] = t.feature
            arrs[f"t{i}"] = t.threshold
            arrs[f"p{i}"] = t.leaf_probs
            arrs[f"d{i}"] = np.int64(t.depth)
        np.savez(path, **arrs)
    else:
        raise TypeError(f"unknown model type {type(model).__name__}")


def load_model(path: str):
    """Load a model written by :func:`save_model`."""
    z = np.load(path, allow_pickle=False)
    kind = str(z["kind"])
    if kind == "fern":
        return Fern(z["features"], z["thresholds"], z["leaf_probs"])
    if kind == "tree":
        return DecisionTree(z["feature"], z["threshold"], z["leaf_probs"],
                            int(z["depth"]))
    if kind == "forest":
        trees = [DecisionTree(z[f"f{i}"], z[f"t{i}"], z[f"p{i}"],
                              int(z[f"d{i}"]))
                 for i in range(int(z["n_trees"]))]
        return RandomForest(trees)
    raise ValueError(f"unknown model kind {kind!r} in {path}")
