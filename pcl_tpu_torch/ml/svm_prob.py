"""SVM probability estimates and cross-validation (libsvm's
``sigmoid_train``, ``svm_binary_svc_probability`` and
``svm_cross_validation`` behind PCL's SVM wrapper).

Counterpart of ``pcl_tpu/ml/svm_prob.py``. Platt scaling fits ``p(+1 | f) =
1 / (1 + exp(A f + B))`` to cross-validated decision values by Newton's
method with backtracking (host numpy, copied); the folds come from the same
numpy permutation, and each fold trains on ``device`` (default CUDA).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import _device


class PlattScaling(NamedTuple):
    A: float
    B: float


def platt_calibrate(decisions, labels, max_iters: int = 100,
                    min_step: float = 1e-10, sigma: float = 1e-12) -> PlattScaling:
    """Fit the Platt sigmoid to (decision, +/-1 label) pairs by libsvm's
    Newton-with-backtracking procedure (Lin, Lin and Weng's form of Platt
    1999), on the regularised targets ``(n+ + 1) / (n+ + 2)`` and
    ``1 / (n- + 2)``."""
    f = np.asarray(decisions, np.float64)
    y = np.asarray(labels)
    prior1 = int(np.sum(y > 0))
    prior0 = len(y) - prior1
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = np.where(y > 0, hi, lo)

    A = 0.0
    B = np.log((prior0 + 1.0) / (prior1 + 1.0))

    def nll(a, b):
        fApB = f * a + b
        pos = fApB >= 0
        out = np.where(pos,
                       t * fApB + np.log1p(np.exp(-fApB)),
                       (t - 1.0) * fApB + np.log1p(np.exp(fApB)))
        return float(np.sum(out))

    fval = nll(A, B)
    for _ in range(max_iters):
        fApB = f * A + B
        p = np.where(fApB >= 0,
                     np.exp(-fApB) / (1.0 + np.exp(-fApB)),
                     1.0 / (1.0 + np.exp(fApB)))
        q = 1.0 - p
        d1 = t - p
        d2 = p * q
        g1 = float(np.sum(f * d1))
        g2 = float(np.sum(d1))
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        h11 = float(np.sum(f * f * d2)) + sigma
        h22 = float(np.sum(d2)) + sigma
        h21 = float(np.sum(f * d2))
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= min_step:
            newA, newB = A + step * dA, B + step * dB
            newf = nll(newA, newB)
            if newf < fval + 1e-4 * step * gd:
                A, B, fval = newA, newB, newf
                break
            step /= 2.0
        else:
            break                       # the line search failed
    return PlattScaling(float(A), float(B))


def platt_probability(scaling: PlattScaling, decisions) -> np.ndarray:
    """``p(y=+1 | f) = 1 / (1 + exp(A f + B))`` (libsvm sigmoid_predict)."""
    fApB = np.asarray(decisions, np.float64) * scaling.A + scaling.B
    return np.where(fApB >= 0,
                    np.exp(-fApB) / (1.0 + np.exp(-fApB)),
                    1.0 / (1.0 + np.exp(fApB)))


def _fns(train_fn, classify_fn):
    from pcl_tpu_torch.ml.svm import svm_classify_dual, svm_train_dual
    return train_fn or svm_train_dual, classify_fn or svm_classify_dual


def _folds(x, y, n_folds, seed, train_fn, classify_fn, device, train_kw):
    """Each row's decision value from the fold that held it out."""
    dev = _device(device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    n = len(x)
    perm = np.random.default_rng(seed).permutation(n)
    dec = np.zeros(n, np.float64)
    for k in range(n_folds):
        held = perm[k::n_folds]
        tr = np.setdiff1d(perm, held)
        m = train_fn(torch.as_tensor(x[tr], device=dev), torch.as_tensor(y[tr], device=dev),
                     **train_kw)
        dec[held] = classify_fn(m, torch.as_tensor(x[held], device=dev)).cpu().numpy()
    return x, y, dec, dev


def svm_train_probability(
    x,
    y,
    n_folds: int = 5,
    seed: int = 0,
    train_fn: Optional[Callable] = None,
    classify_fn: Optional[Callable] = None,
    device=None,
    **train_kw,
) -> Tuple[object, PlattScaling]:
    """Train an SVM on all rows and fit its Platt sigmoid on ``n_folds``-fold
    cross-validated decision values: ``(model, PlattScaling)``."""
    train_fn, classify_fn = _fns(train_fn, classify_fn)
    x, y, dec, dev = _folds(x, y, n_folds, seed, train_fn, classify_fn, device, train_kw)
    model = train_fn(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev), **train_kw)
    return model, platt_calibrate(dec, y)


def svm_predict_probability(model, scaling: PlattScaling, x,
                            classify_fn: Optional[Callable] = None) -> np.ndarray:
    """Per-row ``p(y=+1)`` from the model's decision values (on the model's
    device)."""
    _, classify_fn = _fns(None, classify_fn)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=model.mean.device)
    return platt_probability(scaling, classify_fn(model, xt).cpu().numpy())


def svm_cross_validation(
    x,
    y,
    n_folds: int = 5,
    seed: int = 0,
    train_fn: Optional[Callable] = None,
    classify_fn: Optional[Callable] = None,
    device=None,
    **train_kw,
) -> float:
    """``n_folds``-fold cross-validation accuracy: the share of rows whose
    held-out decision has the sign of their label."""
    train_fn, classify_fn = _fns(train_fn, classify_fn)
    x, y, dec, _ = _folds(x, y, n_folds, seed, train_fn, classify_fn, device, train_kw)
    return int(np.sum(np.sign(dec.astype(np.float32)) == np.sign(y))) / float(len(x))
