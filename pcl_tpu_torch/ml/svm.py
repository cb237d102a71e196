"""SVM training and classification (PCL's libsvm wrapper, SVMTrain and
SVMClassify).

Counterpart of ``pcl_tpu/ml/svm.py``. ``svm_train`` minimises the primal
squared hinge by full-batch gradient descent (the gradient in closed form,
one ``[N, D]`` product a step); ``svm_train_dual`` solves the box-constrained
dual with the bias folded into the kernel by FISTA-accelerated projected
gradient. Kernels: linear and RBF.

The RBF primal trainer's basis is a random subset of the valid rows. The JAX
package draws it with ``jax.random.categorical``; here a sampler draws it
(``svm_basis_indices``, ``torch.multinomial``) and the core takes the drawn
indices (``svm_train_core``), so the tests feed the core the JAX draws
(ROADMAP C17).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pcl_tpu_torch.sac.ransac import categorical


class SVMModel(NamedTuple):
    kernel: str                 # "linear" or "rbf"; chooses svm_classify's form
    w: torch.Tensor             # [D] (linear) or dual coefficients [M] (rbf)
    b: torch.Tensor             # scalar
    support: torch.Tensor       # [M, D] support set (rbf; empty for linear)
    gamma: torch.Tensor         # scalar (rbf)
    mean: torch.Tensor          # [D] feature normalisation
    scale: torch.Tensor         # [D]


def _normalise(x: torch.Tensor, wgt: torch.Tensor):
    """The weighted mean, the inverse standard deviation (floored at 1e-12
    variance) and the normalised rows."""
    den = torch.clamp(torch.sum(wgt), min=1.0)
    mean = torch.sum(x * wgt[:, None], dim=0) / den
    var = torch.sum(((x - mean) ** 2) * wgt[:, None], dim=0) / den
    scale = 1.0 / torch.sqrt(torch.clamp(var, min=1e-12))
    return mean, scale, (x - mean) * scale


def _rbf(xs: torch.Tensor, support: torch.Tensor, gamma) -> torch.Tensor:
    d2 = torch.sum(xs * xs, 1)[:, None] + torch.sum(support * support, 1)[None, :] \
        - 2.0 * (xs @ support.T)
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def _prepare(x, y, mask):
    n = x.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=x.device)
    y = torch.where(y > 0, 1.0, -1.0).to(torch.float32)
    return y, mask.to(torch.float32)


def svm_basis_indices(mask: torch.Tensor, n_basis: int = 256,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The sampler of the RBF primal trainer: ``n_basis`` row indices drawn
    with replacement, uniform over the valid rows."""
    if generator is None:
        generator = torch.Generator(device=mask.device)
        generator.manual_seed(0)
    return categorical(generator, mask.to(torch.float32), (n_basis,))


def svm_train_core(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    kernel: str = "linear",
    C: float = 1.0,
    gamma: float = 1.0,
    iterations: int = 1000,
    lr: float = 0.02,
    basis: Optional[torch.Tensor] = None,
) -> SVMModel:
    """The primal trainer on drawn basis indices ``basis [n_basis]`` (RBF
    only): ``iterations`` steps of gradient descent on ``0.5 |w|^2 + C
    mean(h^2)``, ``h = max(0, 1 - y (f w + b))`` over the valid rows."""
    y, wgt = _prepare(x, y, mask)
    mean, scale, xs = _normalise(x, wgt)
    if kernel == "linear":
        feats = xs
        support = torch.zeros((0, x.shape[1]), dtype=torch.float32, device=x.device)
        gm = 0.0
    elif kernel == "rbf":
        support = xs[basis.long()]
        feats = _rbf(xs, support, gamma)
        gm = gamma
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    c = C / torch.clamp(torch.sum(wgt), min=1.0)
    w = torch.zeros(feats.shape[1], dtype=torch.float32, device=x.device)
    b = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iterations):
        h = torch.clamp(1.0 - y * (feats @ w + b), min=0.0)
        r = c * (wgt * (-2.0 * h * y))           # d loss / d m, row by row
        w, b = w - lr * (w + r @ feats), b - lr * torch.sum(r)
    return SVMModel(kernel=kernel, w=w, b=b, support=support,
                    gamma=torch.tensor(gm, dtype=torch.float32, device=x.device),
                    mean=mean, scale=scale)


def svm_train(x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
              kernel: str = "linear", C: float = 1.0, gamma: float = 1.0,
              iterations: int = 1000, lr: float = 0.02, n_basis: int = 256,
              generator: Optional[torch.Generator] = None) -> SVMModel:
    """Train a primal SVM: the basis sampler (RBF), then the core."""
    basis = None
    if kernel == "rbf":
        m = torch.ones(x.shape[0], dtype=torch.bool, device=x.device) if mask is None else mask
        basis = svm_basis_indices(m, n_basis, generator)
    return svm_train_core(x, y, mask, kernel=kernel, C=C, gamma=gamma, iterations=iterations,
                          lr=lr, basis=basis)


def svm_classify(model: SVMModel, x: torch.Tensor) -> torch.Tensor:
    """Decision values ``[N]`` (positive = class +1)."""
    xs = (x - model.mean) * model.scale
    if model.kernel == "linear":
        return xs @ model.w + model.b
    return _rbf(xs, model.support, model.gamma) @ model.w + model.b


def svm_train_dual(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    kernel: str = "rbf",
    C: float = 1.0,
    gamma: float = 1.0,
    iterations: int = 1200,
) -> SVMModel:
    """The C-SVM dual ``max 1'a - a'Qa / 2``, ``0 <= a <= C``, with the bias
    folded into the kernel (``K + 1``), so no equality constraint is left:
    FISTA-accelerated projected gradient, step ``1 / |Q|_2`` from 16 power
    iterations. The support set is every training row, with weights ``a y``;
    ``b = y'a``."""
    n = x.shape[0]
    y, wgt = _prepare(x, y, mask)
    mean, scale, xs = _normalise(x, wgt)
    if kernel == "rbf":
        K = _rbf(xs, xs, gamma)
    elif kernel == "linear":
        K = xs @ xs.T
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    Q = (y[:, None] * y[None, :]) * (K + 1.0)
    Q = Q * wgt[:, None] * wgt[None, :]
    v = torch.ones(n, dtype=torch.float32, device=x.device) / torch.sqrt(
        torch.tensor(float(n), dtype=torch.float32, device=x.device))
    for _ in range(16):
        v = Q @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    eta = 1.0 / torch.clamp(torch.linalg.vector_norm(Q @ v), min=1e-6)

    def project(a):
        return torch.clamp(a, 0.0, C) * wgt

    a = torch.zeros(n, dtype=torch.float32, device=x.device)
    z = a
    t = torch.ones((), dtype=torch.float32, device=x.device)
    for _ in range(iterations):
        a_new = project(z + eta * (1.0 - Q @ z))
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = a_new + (t - 1.0) / t_new * (a_new - a)
        a, t = a_new, t_new
    a = project(a)
    return SVMModel(kernel=kernel, w=a * y, b=torch.dot(y * wgt, a), support=xs,
                    gamma=torch.tensor(gamma if kernel == "rbf" else 0.0, dtype=torch.float32,
                                       device=x.device),
                    mean=mean, scale=scale)


def svm_classify_dual(model: SVMModel, x: torch.Tensor) -> torch.Tensor:
    """Decision values of a dual-trained (or loaded) model: the kernel
    expansion over its support set."""
    xs = (x - model.mean) * model.scale
    if float(model.gamma) == 0.0:
        K = xs @ model.support.T
    else:
        K = _rbf(xs, model.support, model.gamma)
    return K @ model.w + model.b
