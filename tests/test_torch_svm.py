"""Parity of the port's ``ml.svm``, ``ml.svm_prob`` and ``ml.svm_io`` with
the JAX package on the CPU.

Tolerances:
- The primal trainer: 1,000 float32 gradient steps, summed in other orders
  by the two libraries: ``w`` and ``b`` to 1e-4 relative to ``|w|`` (my CPU
  run: at most 3.4e-7 on these sets). The RBF primal trainer runs its core on the
  JAX package's basis draw (ROADMAP C17).
- The dual trainer (1,200 FISTA steps over an ``[N, N]`` kernel): the dual
  weights to 1e-4 of their largest and ``b`` to 1e-4 relative (my CPU run:
  3.5e-6 and 1.5e-5 at most).
- Decisions: to 1e-4 of the largest; their signs equal wherever ``|m| >
  1e-3``.
- Platt scaling is numpy on both sides: given the same decisions, equal. On
  each package's own cross-validated decisions, ``A`` and ``B`` to 1e-3
  relative; the cross-validation accuracies equal.
- Model files: a model carried across (``interop``) writes the same bytes
  in both packages, and each package's files load in the other.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.ml import svm as jsvm
from pcl_tpu.ml import svm_io as jio
from pcl_tpu.ml import svm_prob as jprob

from pcl_tpu_torch import interop
from pcl_tpu_torch.ml import svm as tsvm
from pcl_tpu_torch.ml import svm_io as tio
from pcl_tpu_torch.ml import svm_prob as tprob


def _blobs(n=90, d=6, seed=0, sep=1.2):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    x = (rng.normal(size=(n, d)) + sep * y[:, None] * np.linspace(1, 0.2, d)[None, :]
         + np.linspace(0, 5, d)[None, :]).astype(np.float32)
    mask = np.ones(n, bool)
    mask[[3, 17, n - 5]] = False
    return x, y, mask


def _t(x):
    return torch.from_numpy(np.array(x))


def _a(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_decisions(a, b):
    a, b = _a(a), np.asarray(b)
    np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())
    firm = np.abs(b) > 1e-3
    assert firm.mean() > 0.9
    np.testing.assert_array_equal(np.sign(a[firm]), np.sign(b[firm]))


def _port_model(m, kernel):
    return interop.svm_model_from_arrays(kernel, m.w, m.b, m.support, m.gamma, m.mean, m.scale,
                                         device="cpu")


@pytest.mark.parametrize("C,use_mask", [(1.0, True), (10.0, False)])
def test_linear_primal_training_matches_jax(C, use_mask):
    x, y, mask = _blobs()
    m = mask if use_mask else None
    j = jsvm.svm_train(jnp.asarray(x), jnp.asarray(y), None if m is None else jnp.asarray(m),
                       kernel="linear", C=C)
    p = tsvm.svm_train(_t(x), _t(y), None if m is None else _t(m), kernel="linear", C=C)
    w = np.asarray(j.w)
    np.testing.assert_allclose(_a(p.w), w, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(float(p.b), float(j.b), atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(_a(p.mean), np.asarray(j.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_a(p.scale), np.asarray(j.scale), rtol=1e-6)
    _same_decisions(tsvm.svm_classify(p, _t(x)), jsvm.svm_classify(j, jnp.asarray(x)))


def test_rbf_primal_training_matches_jax_on_its_basis():
    x, y, mask = _blobs(seed=1)
    key = jax.random.PRNGKey(3)
    n_basis = 32
    w = mask.astype(np.float32)
    probs = jnp.asarray(w / w.sum())
    idx = jax.random.categorical(key, jnp.log(probs + 1e-30)[None, :].repeat(n_basis, 0))
    j = jsvm.svm_train(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), kernel="rbf",
                       gamma=0.2, n_basis=n_basis, key=key)
    p = tsvm.svm_train_core(_t(x), _t(y), _t(mask), kernel="rbf", gamma=0.2,
                            basis=_t(np.asarray(idx)))
    np.testing.assert_allclose(_a(p.support), np.asarray(j.support), rtol=1e-6, atol=1e-6)
    wj = np.asarray(j.w)
    np.testing.assert_allclose(_a(p.w), wj, atol=1e-4 * np.abs(wj).max())
    np.testing.assert_allclose(float(p.b), float(j.b), atol=1e-4 * np.abs(wj).max())
    _same_decisions(tsvm.svm_classify(p, _t(x)), jsvm.svm_classify(j, jnp.asarray(x)))
    # the sampler draws valid rows only
    g = torch.Generator().manual_seed(0)
    drawn = tsvm.svm_basis_indices(_t(mask), 500, g).numpy()
    assert mask[drawn].all() and len(np.unique(drawn)) > 40


@pytest.mark.parametrize("kernel,gamma", [("rbf", 0.3), ("linear", 1.0)])
def test_dual_training_matches_jax(kernel, gamma):
    x, y, mask = _blobs(n=70, seed=2, sep=0.8)
    j = jsvm.svm_train_dual(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), kernel=kernel,
                            gamma=gamma, C=2.0)
    p = tsvm.svm_train_dual(_t(x), _t(y), _t(mask), kernel=kernel, gamma=gamma, C=2.0)
    wj = np.asarray(j.w)
    np.testing.assert_allclose(_a(p.w), wj, atol=1e-4 * np.abs(wj).max())
    np.testing.assert_allclose(float(p.b), float(j.b), rtol=1e-4, atol=1e-6)
    assert float(p.gamma) == float(j.gamma)
    _same_decisions(tsvm.svm_classify_dual(p, _t(x)), jsvm.svm_classify_dual(j, jnp.asarray(x)))


def test_platt_scaling_and_probabilities_match_jax():
    rng = np.random.default_rng(5)
    dec = rng.normal(size=200) * 2
    lab = np.where(dec + rng.normal(size=200) > 0, 1, -1)
    a, b = tprob.platt_calibrate(dec, lab), jprob.platt_calibrate(dec, lab)
    assert a == b
    np.testing.assert_array_equal(tprob.platt_probability(a, dec), jprob.platt_probability(b, dec))


def test_probability_training_and_cross_validation_match_jax():
    x, y, _ = _blobs(n=60, seed=4, sep=0.7)
    kw = dict(kernel="rbf", gamma=0.3, iterations=400)
    jm, js = jprob.svm_train_probability(x, y, n_folds=3, seed=2, **kw)
    tm, ts = tprob.svm_train_probability(x, y, n_folds=3, seed=2, device="cpu", **kw)
    np.testing.assert_allclose([ts.A, ts.B], [js.A, js.B], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tprob.svm_predict_probability(tm, ts, x),
                               jprob.svm_predict_probability(jm, js, x), atol=1e-3)
    acc_t = tprob.svm_cross_validation(x, y, n_folds=3, seed=2, device="cpu", **kw)
    acc_j = jprob.svm_cross_validation(x, y, n_folds=3, seed=2, **kw)
    assert acc_t == acc_j and 0.6 < acc_t <= 1.0


@pytest.mark.parametrize("kind", ["primal linear", "dual rbf", "dual linear"])
def test_model_files_cross_the_packages(tmp_path, kind):
    x, y, mask = _blobs(n=40, seed=6)
    if kind == "primal linear":
        j = jsvm.svm_train(jnp.asarray(x), jnp.asarray(y), kernel="linear", iterations=200)
        kernel = "linear"
    else:
        kernel = kind.split()[1]
        xn = x if kernel == "linear" else (x - x.mean(0)) / x.std(0)
        j = jsvm.svm_train_dual(jnp.asarray(xn), jnp.asarray(y), kernel=kernel, gamma=0.5,
                                iterations=200)
        if kernel == "rbf":      # libsvm keeps no normalisation: identity for RBF files
            j = j._replace(mean=jnp.zeros_like(j.mean), scale=jnp.ones_like(j.scale))
    p = _port_model(j, kernel)
    platt = jprob.PlattScaling(-1.25, 0.125)
    fj, fp = tmp_path / "jax.model", tmp_path / "port.model"
    jio.save_libsvm_model(str(fj), j, platt=platt)
    tio.save_libsvm_model(str(fp), p, platt=tprob.PlattScaling(*platt))
    assert fj.read_bytes() == fp.read_bytes()
    # each package loads the other's file, and both classify alike
    tp = tio.load_libsvm_model(str(fj), device="cpu")
    jp = jio.load_libsvm_model(str(fp))
    for name in ("w", "b", "support", "gamma", "mean", "scale"):
        np.testing.assert_array_equal(_a(getattr(tp, name)), np.asarray(getattr(jp, name)))
    assert tp.kernel == jp.kernel
    _same_decisions(tsvm.svm_classify_dual(tp, _t(x)), jsvm.svm_classify_dual(jp, jnp.asarray(x)))
    assert tuple(tio.load_libsvm_probability(str(fj))) == tuple(jio.load_libsvm_probability(
        str(fp)))


def test_files_with_label_order_minus_one_first(tmp_path):
    f = tmp_path / "m.model"
    f.write_text("svm_type c_svc\nkernel_type rbf\ngamma 0.5\nnr_class 2\ntotal_sv 3\n"
                 "rho 0.25\nlabel -1 1\nprobA -2.0\nprobB 0.5\nnr_sv 2 1\nSV\n"
                 "0.5 1:1 3:0.5\n0.25 2:-1\n-0.75 1:0.25 2:0.5 3:1\n")
    tp, jp = tio.load_libsvm_model(str(f), device="cpu"), jio.load_libsvm_model(str(f))
    for name in ("w", "b", "support", "gamma"):
        np.testing.assert_array_equal(_a(getattr(tp, name)), np.asarray(getattr(jp, name)))
    assert tuple(tio.load_libsvm_probability(str(f))) == tuple(jio.load_libsvm_probability(
        str(f)))
    with pytest.raises(ValueError, match="svm_type"):
        g = tmp_path / "bad.model"
        g.write_text("svm_type nu_svc\nrho 0\nSV\n")
        tio.load_libsvm_model(str(g), device="cpu")
