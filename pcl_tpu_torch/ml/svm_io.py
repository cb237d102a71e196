"""libsvm model files (the format of libsvm's ``svm_save_model``, which
PCL's SVMTrain and SVMClassify read and write).

Counterpart of ``pcl_tpu/ml/svm_io.py``: 2-class ``c_svc`` models with a
linear or RBF kernel. A loaded model classifies through
``svm_classify_dual`` (the kernel expansion over its support vectors), with
positive meaning label +1 whatever the file's label order. The text is
written as the JAX package writes it, so each package's files load in the
other.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.ml.svm import SVMModel
from pcl_tpu_torch.ml.svm_prob import PlattScaling

_SUPPORTED_KERNELS = ("linear", "rbf")


def _header(path: str):
    header: Dict[str, List[str]] = {}
    sv_lines: List[str] = []
    with open(path) as f:
        in_sv = False
        for line in f:
            line = line.strip()
            if not line:
                continue
            if in_sv:
                sv_lines.append(line)
            elif line == "SV":
                in_sv = True
            else:
                parts = line.split()
                header[parts[0]] = parts[1:]
    return header, sv_lines


def load_libsvm_model(path: str, device=None) -> SVMModel:
    """A libsvm model file as an SVMModel on ``device`` (default CUDA)."""
    dev = _device(device)
    header, sv_lines = _header(path)
    svm_type = header.get("svm_type", ["c_svc"])[0]
    if svm_type != "c_svc":
        raise ValueError(f"unsupported svm_type {svm_type!r} (c_svc only)")
    ktype = header.get("kernel_type", ["rbf"])[0]
    if ktype not in _SUPPORTED_KERNELS:
        raise ValueError(f"unsupported kernel_type {ktype!r} (linear/rbf only)")
    nr_class = int(header.get("nr_class", ["2"])[0])
    if nr_class != 2:
        raise ValueError(f"only 2-class models supported, got {nr_class}")
    total_sv = int(header.get("total_sv", [str(len(sv_lines))])[0])
    rho = float(header["rho"][0])
    gamma = float(header.get("gamma", ["0"])[0])
    labels = [int(v) for v in header.get("label", ["1", "-1"])]

    coefs = np.zeros((total_sv,), np.float32)
    feats: List[Dict[int, float]] = []
    max_idx = 0
    for i, line in enumerate(sv_lines[:total_sv]):
        parts = line.split()
        coefs[i] = float(parts[0])
        row: Dict[int, float] = {}
        for tok in parts[1:]:
            k, v = tok.split(":")
            row[int(k)] = float(v)
            max_idx = max(max_idx, int(k))
        feats.append(row)
    sv = np.zeros((total_sv, max_idx), np.float32)
    for i, row in enumerate(feats):
        for k, v in row.items():
            sv[i, k - 1] = v          # libsvm indices are 1-based

    # libsvm's decision is sum_i coef_i K(sv_i, x) - rho, for labels[0] when
    # positive; turned so that positive is +1
    b = -rho
    if labels[0] < 0:
        coefs = -coefs
        b = -b
    d = sv.shape[1]

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return SVMModel(kernel=ktype, w=t(coefs), b=t(np.float32(b)), support=t(sv),
                    gamma=t(np.float32(gamma if ktype == "rbf" else 0.0)),
                    mean=torch.zeros(d, dtype=torch.float32, device=dev),
                    scale=torch.ones(d, dtype=torch.float32, device=dev))


def load_libsvm_probability(path: str):
    """The file's Platt sigmoid (``probA``/``probB``) for ``p(+1)``: ``(A,
    -B)`` where the file's first label is -1, whose decisions the loader
    negates. None when the file has none."""
    header, _ = _header(path)
    if "probA" not in header or "probB" not in header:
        return None
    A = float(header["probA"][0])
    B = float(header["probB"][0])
    labels = [int(v) for v in header.get("label", ["1", "-1"])]
    if labels[0] < 0:
        B = -B
    return PlattScaling(A, B)


def _np64(v) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float64) if torch.is_tensor(v) \
        else np.asarray(v, np.float64)


def save_libsvm_model(path: str, model: SVMModel, platt=None) -> None:
    """Write an SVMModel as a libsvm model file.

    Dual models write their support set and coefficients. A primal linear
    model (empty support) writes its weights, normalisation folded in, as one
    linear support vector of coefficient 1: the same decision function. An
    RBF model must have identity normalisation (libsvm has no field for it).
    """
    mean = _np64(model.mean)
    scale = _np64(model.scale)
    w = _np64(model.w)
    b = float(model.b)
    support = _np64(model.support)
    gamma = float(model.gamma)
    is_rbf = gamma != 0.0

    if support.size == 0 or support.ndim != 2 or model.kernel == "linear" \
            and support.shape[0] == 0:
        w_eff = w * scale
        b_eff = b - float(np.dot(w * scale, mean))
        rows = [(1.0, w_eff)]
        rho = -b_eff
        ktype = "linear"
        gamma_out = 0.0
    else:
        if is_rbf and (np.any(mean != 0.0) or np.any(scale != 1.0)):
            raise ValueError(
                "cannot export an rbf model with non-identity feature "
                "normalization to libsvm format (bake the scaling into "
                "the training data instead)")
        if not is_rbf:
            support = (support - mean) * scale
        rows = [(float(c), sv) for c, sv in zip(w, support)]
        rho = -b
        ktype = "rbf" if is_rbf else "linear"
        gamma_out = gamma

    with open(path, "w") as f:
        f.write("svm_type c_svc\n")
        f.write(f"kernel_type {ktype}\n")
        if ktype == "rbf":
            f.write(f"gamma {gamma_out:.17g}\n")
        f.write("nr_class 2\n")
        f.write(f"total_sv {len(rows)}\n")
        f.write(f"rho {rho:.17g}\n")
        f.write("label 1 -1\n")
        if platt is not None:
            f.write(f"probA {platt.A:.17g}\n")
            f.write(f"probB {platt.B:.17g}\n")
        npos = sum(1 for c, _ in rows if c > 0)
        f.write(f"nr_sv {npos} {len(rows) - npos}\n")
        f.write("SV\n")
        for c, sv in rows:
            toks = [f"{c:.17g}"]
            for j, v in enumerate(sv):
                if v != 0.0:
                    toks.append(f"{j + 1}:{v:.17g}")
            f.write(" ".join(toks) + "\n")
