"""Parity of the port's ``ml.permutohedral``, ``ml.densecrf`` and the
``crf_segmentation`` CLI with the JAX package on the CPU.

Tolerances:
- ``build_lattice`` is host numpy on both sides: offsets, barycentric
  weights and blur neighbours equal bit for bit.
- The lattice filter (splat, blur, slice): to 1e-5 of the largest output;
  the two libraries round the slice's weighted sum differently (XLA fuses
  its products into FMAs). The grid filter likewise, to 1e-5.
- DenseCRF after 5-10 mean-field iterations: posteriors to 1e-4, and the
  labels equal wherever the top two posteriors differ by more than 1e-4.
- The CLI: the output labels equal the JAX CLI's (the test's scene has
  every top-two margin above 1e-4, which it checks).
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.ml import densecrf as jcrf
from pcl_tpu.ml import permutohedral as jperm
from pcl_tpu.tools import crf_segmentation as j_cli

from pcl_tpu_torch import interop
from pcl_tpu_torch import io as tio
from pcl_tpu_torch.core.cloud import from_numpy
from pcl_tpu_torch.ml import densecrf as tcrf
from pcl_tpu_torch.ml import permutohedral as tperm
from pcl_tpu_torch.tools import crf_segmentation as t_cli


def _labelled_scene(n=600, seed=0, flip=0.2):
    """Three patches (floor, wall, a box face) with a colour each and a
    share of wrong labels."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 3, n)
    u, v = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    xyz = np.stack([
        np.where(part == 0, u, np.where(part == 1, u, 0.3 + 0.3 * u)),
        np.where(part == 0, 0.0, v),
        np.where(part == 0, v, np.where(part == 1, 1.0, 0.4)),
    ], 1) + 0.003 * rng.normal(size=(n, 3))
    colours = np.array([[0.3, 0.4, 0.6], [0.85, 0.8, 0.7], [0.8, 0.2, 0.1]])
    rgb = np.clip(colours[part] + 0.03 * rng.normal(size=(n, 3)), 0, 1)
    noisy = np.where(rng.random(n) < flip, rng.integers(0, 3, n), part)
    return xyz.astype(np.float32), rgb.astype(np.float32), part, noisy.astype(np.int32)


def _unary(labels, n_classes, conf=0.8):
    n = len(labels)
    p = (1.0 - conf) / (n_classes - 1)
    u = np.full((n, n_classes), -np.log(p), np.float32)
    u[np.arange(n), labels] = -np.log(conf)
    return u


@pytest.mark.parametrize("d,seed", [(2, 0), (3, 1), (6, 2)])
def test_lattice_is_the_jax_lattice_bit_for_bit(d, seed):
    rng = np.random.default_rng(seed)
    feat = (rng.normal(size=(300, d)) * 2.0).astype(np.float32)
    feat[7] = feat[3]                                   # a repeated row
    a, b = tperm.build_lattice(feat), jperm.build_lattice(feat)
    assert (a.m, a.d) == (b.m, b.d)
    for name in ("offsets", "barycentric", "blur_n1", "blur_n2"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("d,channels", [(3, 1), (3, 4), (6, 3)])
def test_lattice_filter_matches_jax(d, channels):
    rng = np.random.default_rng(10 + d + channels)
    feat = (rng.normal(size=(400, d)) * 1.5).astype(np.float32)
    vals = rng.uniform(0, 1, (400, channels)).astype(np.float32)
    jf = jperm.PermutohedralFilter(feat)
    want = np.asarray(jf.compute(jnp.asarray(vals)))
    lat = interop.lattice_from_arrays(*jf.lat)
    got = tperm._compute(torch.from_numpy(vals), *(torch.from_numpy(np.asarray(x)) for x in
                                                   (lat.offsets, lat.barycentric, lat.blur_n1,
                                                    lat.blur_n2)), lat.m, lat.d).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    tf = tperm.PermutohedralFilter(feat, device="cpu")
    np.testing.assert_array_equal(tf.compute(vals).numpy(), got)


@pytest.mark.parametrize("F,n_bins", [(3, 10), (6, 5)])
def test_grid_filter_matches_jax(F, n_bins):
    rng = np.random.default_rng(F)
    feat = (rng.uniform(0, n_bins - 3, (300, F))).astype(np.float32)
    q = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    want = np.asarray(jcrf._grid_filter(jnp.asarray(q), jnp.asarray(feat), n_bins))
    got = tcrf._grid_filter(torch.from_numpy(q), torch.from_numpy(feat), n_bins).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def _crf(mod, xyz, rgb, noisy, bins=12, **kw):
    c = mod.DenseCRF(len(xyz), 3, **kw)
    c.set_unary_energy(_unary(noisy, 3))
    c.add_pairwise_gaussian(xyz, 0.05)
    c.add_pairwise_bilateral(xyz, rgb, 0.2, 0.1, n_bins=bins)
    return c


@pytest.mark.parametrize("impl,iters,bins", [("permutohedral", 10, 12), ("grid", 5, 6)])
def test_dense_crf_matches_jax(impl, iters, bins):
    """The grid's bilateral kernel at 6 bins a side (6^6 cells, not 12^6)."""
    xyz, rgb, part, noisy = _labelled_scene()
    want = _crf(jcrf, xyz, rgb, noisy, bins).inference(iters, filter_impl=impl)
    got = _crf(tcrf, xyz, rgb, noisy, bins, device="cpu").inference(iters, filter_impl=impl)
    np.testing.assert_allclose(got, want, atol=1e-4)
    top2 = np.sort(want, axis=1)[:, -2:]
    firm = top2[:, 1] - top2[:, 0] > 1e-4
    assert firm.mean() > 0.95
    np.testing.assert_array_equal(got.argmax(1)[firm], want.argmax(1)[firm])
    # the CRF repairs the flipped labels
    assert (want.argmax(1) == part).mean() > (noisy == part).mean()


def test_crf_segmentation_cli_matches_jax(tmp_path, capsys):
    xyz, rgb, _, noisy = _labelled_scene(n=300, seed=3)
    q = _crf(jcrf, xyz, rgb, noisy).inference(4)
    top2 = np.sort(q, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-4).all()
    src = str(tmp_path / "in.pcd")
    tio.save(src, from_numpy(xyz, attrs={"rgb": rgb, "label": noisy}, device="cpu"))
    outs = {}
    for name, main, extra in (("jax", j_cli.main, []), ("port", t_cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.pcd")
        assert main([src, out, "-iters", "4", "-sxyz", "0.05"] + extra) == 0
        outs[name] = tio.load(out, device="cpu").attrs["label"].numpy()
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0] == printed[1] and "labels changed" in printed[0]
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    np.testing.assert_array_equal(outs["port"], q.argmax(1))
