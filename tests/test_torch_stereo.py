"""Parity of the port's stereo matching with the JAX package on the CPU.

Tolerances:
- ``block_matching`` and ``adaptive_cost_so_matching``: disparities equal
  wherever the best cost beats the runner-up by more than a relative
  margin of 1e-5, in the left view and in the right view's cost at the
  column the left disparity points to (the LR check); the other pixels may
  take the other disparity when the two packages round the box sums or the
  adaptive weights apart (ROADMAP C88, C89), and are at most 1% of the
  image. So far both packages agree on every pixel.
- ``disparity_to_cloud`` equal bit for bit; ``disparity_to_dem``'s bins,
  counts and mean heights equal bit for bit (``ops.segsum.add_rows`` adds
  in index order, C84, C90).
- The ratio filter: the JAX package's jitted ``block_matching`` raises when
  ``ratio_filter`` is passed (a traced value's truth, C88); its body jitted
  with the filter as a constant is the reference.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from pcl_tpu import stereo as jst
from pcl_tpu.stereo import matching as jmatch

from pcl_tpu_torch import stereo as tst
from pcl_tpu_torch.stereo import advanced as tadv
from pcl_tpu_torch.stereo import matching as tmatch

MARGIN = 1e-5


def _pair(seed, H=40, W=96, d=6, noise=1.0, step=False):
    """A textured left image and its right view ``d`` px apart (with
    ``step``, a nearer block shifted twice as far: an occlusion)."""
    rng = np.random.default_rng(seed)
    off = 2 * d + 8
    tex = gaussian_filter(rng.uniform(0, 255, (H, W + 2 * off)), 1.0).astype(np.float32)
    left = tex[:, off:off + W].copy()
    right = tex[:, off + d:off + d + W].copy()      # left[x] = right[x - d]
    if step:
        near = gaussian_filter(rng.uniform(0, 255, (H, W)), 1.2).astype(np.float32)
        r0, r1, c0, c1 = H // 4, 3 * H // 4, W // 3, 2 * W // 3
        left[r0:r1, c0:c1] = near[r0:r1, c0:c1]
        right[r0:r1, c0 - 2 * d:c1 - 2 * d] = near[r0:r1, c0:c1]
    right = right + rng.normal(scale=noise, size=right.shape).astype(np.float32)
    return left, right


def _margins(costs, axis):
    """Relative gap of each pixel's runner-up cost over its best."""
    two = np.sort(costs, axis=axis).take([0, 1], axis=axis)
    best, second = two.take(0, axis=axis), two.take(1, axis=axis)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(np.isfinite(second), (second - best) / np.maximum(np.abs(best), 1e-30),
                        np.inf)


def _firm(margin_l, margin_r, disp):
    """Pixels whose left cost and whose right cost at the column the
    disparity points to both beat their runner-up by ``MARGIN``."""
    H, W = disp.shape
    col = np.clip(np.arange(W)[None, :] - np.maximum(disp, 0).astype(int), 0, W - 1)
    return (margin_l > MARGIN) & (np.take_along_axis(margin_r, col, 1) > MARGIN)


def _held(got, want, firm):
    np.testing.assert_array_equal(got[firm], want[firm])
    assert (~firm).mean() <= 0.01
    return int((got != want).sum())


@pytest.mark.parametrize("seed,d,kw", [
    (0, 6, dict(max_disparity=16)),
    (1, 9, dict(max_disparity=24, window_radius=2)),
    (2, 5, dict(max_disparity=16, lr_check=False)),
    (3, 4, dict(max_disparity=12, window_radius=4, lr_tolerance=0)),
])
@pytest.mark.parametrize("step", [False, True])
def test_block_matching_matches_jax_off_near_ties(seed, d, kw, step):
    left, right = _pair(seed, d=d, step=step)
    want = np.asarray(jst.block_matching(jnp.asarray(left), jnp.asarray(right), **kw))
    got = tst.block_matching(torch.from_numpy(left), torch.from_numpy(right), **kw).numpy()
    D, r = kw["max_disparity"], kw.get("window_radius", 3)
    cl = tmatch.block_costs(torch.from_numpy(left), torch.from_numpy(right), D, r).numpy()
    cr = tmatch.block_costs(torch.from_numpy(left), torch.from_numpy(right), D, r,
                            right_view=True).numpy()
    firm = _firm(_margins(cl, 0), _margins(cr, 0) if kw.get("lr_check", True) else
                 np.full(left.shape, np.inf), np.argmin(cl, 0))
    assert _held(got, want, firm) == 0
    valid = got >= 0
    assert valid.mean() > 0.5
    assert np.mean(np.abs(got[valid][:, None] - [d, 2 * d]).min(1) <= 1) > 0.9


def test_block_matching_ratio_filter_matches_jax_body():
    left, right = _pair(4, d=7, noise=8.0)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jst.block_matching(jnp.asarray(left), jnp.asarray(right), max_disparity=16,
                           ratio_filter=0.05)
    for ratio in (0.02, 0.1):
        ref = jax.jit(lambda a, b, ratio=ratio: jmatch.block_matching.__wrapped__(
            a, b, max_disparity=16, ratio_filter=ratio))
        want = np.asarray(ref(jnp.asarray(left), jnp.asarray(right)))
        got = tst.block_matching(torch.from_numpy(left), torch.from_numpy(right),
                                 max_disparity=16, ratio_filter=ratio).numpy()
        np.testing.assert_array_equal(got, want)
        plain = tst.block_matching(torch.from_numpy(left), torch.from_numpy(right),
                                   max_disparity=16).numpy()
        assert (got < 0).sum() > (plain < 0).sum()


@pytest.mark.parametrize("seed,d,kw", [
    (5, 6, dict(max_disparity=16)),
    (6, 4, dict(max_disparity=12, radius=1, smoothness_weak=10.0, smoothness_strong=60.0)),
])
@pytest.mark.parametrize("step", [False, True])
def test_adaptive_cost_so_matching_matches_jax_off_near_ties(seed, d, kw, step):
    left, right = _pair(seed, d=d, step=step)
    want = np.asarray(jst.adaptive_cost_so_matching(jnp.asarray(left), jnp.asarray(right),
                                                    **kw))
    got = tst.adaptive_cost_so_matching(torch.from_numpy(left), torch.from_numpy(right),
                                        **kw).numpy()
    agg_kw = {k: v for k, v in kw.items() if k != "lr_tolerance"}
    agg = tadv.adaptive_aggregate(torch.from_numpy(left), torch.from_numpy(right),
                                  **agg_kw).numpy()
    rcost = np.stack([np.roll(agg[..., k], -k, 1) for k in range(agg.shape[-1])], -1)
    firm = _firm(_margins(agg, -1), _margins(rcost, -1), np.argmin(agg, -1))
    assert _held(got, want, firm) == 0
    valid = got >= 0
    assert valid.mean() > 0.5
    assert np.mean(np.abs(got[valid][:, None] - [d, 2 * d]).min(1) <= 1) > 0.8


@pytest.mark.parametrize("u0,v0", [(None, None), (47.5, 19.5)])
def test_disparity_to_cloud_matches_jax(u0, v0):
    rng = np.random.default_rng(7)
    disp = rng.uniform(-3, 40, (40, 96)).astype(np.float32)
    disp[disp < 0.5] = -1.0
    jc = jst.disparity_to_cloud(jnp.asarray(disp), 525.0, 0.12, u0, v0)
    tc = tst.disparity_to_cloud(torch.from_numpy(disp), 525.0, 0.12, u0, v0)
    np.testing.assert_array_equal(tc.xyz.numpy(), np.asarray(jc.xyz))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    assert (tc.width, tc.height) == (jc.width, jc.height) == (96, 40)


@pytest.mark.parametrize("kw", [dict(), dict(dem_cols=10, dem_disp_bins=7, min_disparity=3.0)])
def test_disparity_to_dem_matches_jax_in_its_bins(kw):
    rng = np.random.default_rng(8)
    H, W = 48, 80
    disp = np.round(rng.uniform(-2, 30, (H, W))).astype(np.float32)
    disp[:, :10] = 12.0                              # many pixels in one bin
    inten = rng.uniform(0, 255, (H, W)).astype(np.float32)
    args = (525.0, 0.12, 39.5, 23.5)
    hj, nj = jst.disparity_to_dem(jnp.asarray(disp), jnp.asarray(inten), *args, **kw)
    ht, nt = tst.disparity_to_dem(torch.from_numpy(disp), torch.from_numpy(inten), *args, **kw)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert nt.sum() == (disp >= kw.get("min_disparity", 1.0)).sum()
