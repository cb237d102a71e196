"""Parity of the port's organized edge detection, image extractors and
bearing-angle image with the JAX package on the CPU.

Tolerances:
- ``organized_edge_detection``: labels equal bit for bit for all five edge
  types together and each alone, on an organized scene with a step in depth,
  holes of dropped pixels and RGB patches, both packages given the same
  normals (integral normals differ by ROADMAP C26). The NaN march's
  ``floor(d * s)`` flips when ``d * s`` lies within rounding of an integer;
  the test counts the marching pixels whose ``dx * s`` or ``dy * s`` lies
  within 1e-6 of an integer for some ``s`` below ``max_search_neighbors``
  and compares the labels everywhere else (ROADMAP C91). The march's mean
  direction is exact in both, so that count is reported, not used to
  excuse a difference (none is left out in these scenes but where
  ``dx * s`` is an integer exactly, which both packages floor alike).
- Extractors and ``bearing_angle_image``: host numpy in both after one read
  back, so the images are equal bit for bit; ``edge_label_indices`` equal.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcl_tpu.core.cloud import make_cloud as jmake
from pcl_tpu.features import organized_edge as jedge
from pcl_tpu.image import extractors as jext

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.features import organized_edge as tedge
from pcl_tpu_torch.image import extractors as text

H, W = 48, 64


def _scene(seed=0, holes=0.03):
    """An organized cloud: a wall at 3 m, a box at 1.5 m in front of it and
    a floor strip, dropped pixels (NaN) and a few larger holes; RGB patches
    on 0..255, smooth normals with some creases, labels, intensity,
    curvature."""
    rng = np.random.default_rng(seed)
    f, cx, cy = 60.0, (W - 1) / 2, (H - 1) / 2
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    z = np.full((H, W), 3.0)
    z[12:34, 18:40] = 1.5
    z[38:, :] = 2.0 + 0.02 * (v[38:, :] - 38)
    z += rng.normal(scale=0.002, size=z.shape)
    drop = rng.random((H, W)) < holes
    drop[20:24, 10:14] = True                      # a hole beside the box
    drop[5:9, 50:58] = True
    z[drop] = np.nan
    xyz = np.stack([(u - cx) / f * z, (v - cy) / f * z, z], -1).astype(np.float32)
    valid = ~drop
    rgb = np.zeros((H, W, 3), np.float32)
    rgb[..., 0] = 40 + 160 * ((u // 8 + v // 8) % 2)
    rgb[..., 1] = 90 + 100 * (z < 2.0)
    rgb[..., 2] = 120 + rng.normal(scale=5.0, size=(H, W))
    ang = 0.3 * np.sin(u / 7.0) + 0.6 * (z < 2.0)
    nrm = np.stack([np.sin(ang), 0.2 * np.cos(v / 5.0), -np.cos(ang)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    label = (z < 2.0).astype(np.int32) + 2 * (v >= 38)
    inten = (100 * np.sin(u / 9.0) + 120).astype(np.float32)
    curv = np.abs(np.sin(v / 6.0) * np.cos(u / 11.0)).astype(np.float32) * 0.1
    attrs = dict(rgb=rgb.reshape(-1, 3), normal=nrm.reshape(-1, 3).astype(np.float32),
                 label=label.reshape(-1), intensity=inten.reshape(-1),
                 curvature=curv.reshape(-1))
    return xyz.reshape(-1, 3), valid.reshape(-1), attrs


def _clouds(seed=0, holes=0.03, rgb01=False):
    xyz, valid, attrs = _scene(seed, holes)
    if rgb01:
        attrs = dict(attrs, rgb=attrs["rgb"] / 255.0)
    xyz = np.where(valid[:, None], xyz, np.nan).astype(np.float32)
    jc = jmake(jnp.asarray(np.nan_to_num(xyz)), jnp.asarray(valid),
               {k: jnp.asarray(a) for k, a in attrs.items()}, width=W, height=H)
    tc = make_cloud(np.nan_to_num(xyz), valid, attrs, width=W, height=H, device="cpu")
    return jc, tc


def _near_integer_pixels(tc, steps):
    """Marching pixels whose ``d * s`` lies within 1e-6 of an integer (not
    on it) for some step ``s``, by the port's exact mean direction."""
    h, w = tc.height, tc.width
    finite = tc.mask.reshape(h, w)
    inv = torch.stack([~tedge._shift(finite, dc, dr, False) for dc, dr in tedge._DIRS])
    dx, dy = (t.double().numpy() for t in tedge.march_steps(inv))
    s = np.arange(1, steps, dtype=np.float64)[:, None, None]
    near = np.zeros((h, w), bool)
    for d in (dx, dy):
        x = d[None] * s
        gap = np.abs(x - np.round(x))
        near |= ((gap > 0) & (gap <= 1e-6)).any(0)
    return near.reshape(-1)


ALL = 31


@pytest.mark.parametrize("edge_types", [ALL, 1, 2, 4, 8, 16, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_organized_edges_match_jax(edge_types, seed):
    jc, tc = _clouds(seed)
    want = np.asarray(jedge.organized_edge_detection(jc, edge_types=edge_types))
    got = tedge.organized_edge_detection(tc, edge_types=edge_types).numpy()
    # equal everywhere, the pixels whose march lies near an integer step too
    near = _near_integer_pixels(tc, 50)
    np.testing.assert_array_equal(got[~near], want[~near])
    np.testing.assert_array_equal(got[near], want[near])
    assert got.dtype == np.int32 and got.shape == (H * W,)
    if edge_types == ALL:
        # every type present in the scene but HIGH_CURVATURE: Canny's default
        # high threshold 1.1 lies above the largest |(n_x, n_y)| of unit
        # normals, so the defaults find none in either package (ROADMAP C91)
        assert [bool(((got >> t) & 1).any()) for t in range(5)] == [True] * 3 + [False, True]
        for a, b in zip(tedge.edge_label_indices(torch.from_numpy(got)),
                        jedge.edge_label_indices(want)):
            np.testing.assert_array_equal(a, b)


def test_organized_edges_short_march_and_thresholds():
    jc, tc = _clouds(2, holes=0.08)
    kw = dict(depth_discon_threshold=0.05, max_search_neighbors=4, edge_types=ALL,
              hc_canny_low=0.2, hc_canny_high=0.6, rgb_canny_low=20.0, rgb_canny_high=60.0)
    want = np.asarray(jedge.organized_edge_detection(jc, **kw))
    got = tedge.organized_edge_detection(tc, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(((got >> t) & 1).any() for t in range(5))


def test_organized_edges_refuse_unorganized_and_missing_attrs():
    tc = make_cloud(np.zeros((10, 3)), device="cpu")
    with pytest.raises(ValueError, match="organized"):
        tedge.organized_edge_detection(tc)
    _, org = _clouds(0)
    with pytest.raises(ValueError, match="normals"):
        tedge.organized_edge_detection(org.without_attrs("normal"), edge_types=8)
    with pytest.raises(ValueError, match="rgb"):
        tedge.organized_edge_detection(org.without_attrs("rgb"), edge_types=16)


@pytest.mark.parametrize("name,kw", [
    ("extract_normal_image", {}),
    ("extract_rgb_image", {}),
    ("extract_label_image", {"color_mode": "mono"}),
    ("extract_label_image", {"color_mode": "rgb_random"}),
    ("extract_label_image", {"color_mode": "rgb_glasbey"}),
    ("extract_z_image", {}),
    ("extract_z_image", {"scaling": "full_range"}),
    ("extract_z_image", {"scaling": "no"}),
    ("extract_curvature_image", {}),
    ("extract_curvature_image", {"scaling": "fixed", "factor": 5e5}),
    ("extract_intensity_image", {}),
    ("bearing_angle_image", {}),
])
@pytest.mark.parametrize("rgb01", [False, True])
def test_extractors_match_jax(name, kw, rgb01):
    jc, tc = _clouds(3, rgb01=rgb01)
    want = getattr(jext, name)(jc, **kw)
    got = getattr(text, name)(tc, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_extractors_refuse_unorganized_and_unknown_modes():
    tc = make_cloud(np.zeros((10, 3)), attrs={"label": np.zeros(10, np.int32)}, device="cpu")
    with pytest.raises(ValueError, match="organized"):
        text.extract_z_image(tc)
    _, org = _clouds(0)
    with pytest.raises(ValueError, match="color mode"):
        text.extract_label_image(org, color_mode="hsv")
    with pytest.raises(ValueError, match="scaling"):
        text.extract_z_image(org, scaling="log")
