"""Range images and NARF of pcl_tpu_torch against the JAX package's on the CPU,
at 60 x 80 to 180 x 360 pixels.

- Projections: the ranges of every pixel are equal, leaving out the pixels a
  point within 1e-4 pixel of a pixel edge can reach (the two packages'
  ``atan2``/``asin`` may round apart, and a pixel is a float32 ``floor``:
  ROADMAP C27); the points so near an edge are counted, and are few. NaN and
  +-3e9 points land in no pixel in either package (C71).
- ``to_cloud`` on the same image: points within 1e-6 of their range (the
  packages' ``sin``/``cos`` may differ by an ulp).
- NARF on the same image (``interop.range_image_from_arrays``): border
  types and scores, interest, every keypoint slot (the invalid ones too:
  the lowest-index ``-inf`` pixels, C74) equal; descriptors within 1e-6.
"""

import torch_threads  # noqa: F401  (one torch thread a Tier-1 worker)
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pcl_tpu.core import range_image as jri
from pcl_tpu.core.cloud import make_cloud as jmake_cloud
from pcl_tpu.features import narf as jnarf

from pcl_tpu_torch import interop
from pcl_tpu_torch.core import range_image as tri
from pcl_tpu_torch.core.cloud import make_cloud as tmake_cloud
from pcl_tpu_torch.features import narf as tnarf

_spec = importlib.util.spec_from_file_location(
    "jax_narf_scenes", Path(__file__).resolve().parent / "test_narf.py")
_narf_scenes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_narf_scenes)

EDGE = 1e-4     # pixels


def _street(seed=0, n=6000):
    """A ground plane, a facade, a box and a pole about the sensor, with some
    invalid points, NaN and +-3e9 among the valid."""
    rng = np.random.default_rng(seed)
    k = n // 4
    ground = np.stack([rng.uniform(-8, 8, k), np.full(k, -1.5), rng.uniform(-8, 12, k)], 1)
    facade = np.stack([rng.uniform(-8, 8, k), rng.uniform(-1.5, 3, k), np.full(k, 9.0)], 1)
    box = np.stack([rng.uniform(-1, 1, k), rng.uniform(-1.5, 0.5, k), np.full(k, 4.0)], 1)
    t = rng.uniform(0, 2 * np.pi, n - 3 * k)
    pole = np.stack([2.5 + 0.2 * np.cos(t), rng.uniform(-1.5, 2.5, len(t)),
                     6.0 + 0.2 * np.sin(t)], 1)
    pts = np.concatenate([ground, facade, box, pole]).astype(np.float32)
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    mask = rng.uniform(size=len(pts)) > 0.03
    pts[:5] = [[np.nan, 0, 1], [3e9, 0, 1], [-3e9, 0, 1], [0, 3e9, 1], [0, 0, 0]]
    mask[:5] = True
    return pts, mask


def _both(pts, mask):
    return (jmake_cloud(jnp.asarray(pts), jnp.asarray(mask)),
            tmake_cloud(torch.from_numpy(pts), torch.from_numpy(mask), device="cpu"))


def _edge_pixels(pts, mask, planar, res, width, height):
    """Flat pixels that a valid point within ``EDGE`` of a pixel edge can
    reach (float64 coordinates), and the number of such points."""
    p = pts.astype(np.float64)
    ok = mask & np.isfinite(p).all(1)
    cx, cy = width / 2.0, height / 2.0
    with np.errstate(all="ignore"):
        if planar:
            a = res * p[:, 0] / p[:, 2] + cx
            b = res * p[:, 1] / p[:, 2] + cy
        else:
            r = np.linalg.norm(p, axis=1)
            a = np.arctan2(p[:, 0], p[:, 2]) / res + cx
            b = np.arcsin(p[:, 1] / r) / res + cy
    near = ok & np.isfinite(a) & np.isfinite(b) & (
        (np.abs(a - np.round(a)) < EDGE) | (np.abs(b - np.round(b)) < EDGE))
    out = set()
    for ai, bi in zip(a[near], b[near]):
        for u in {math.floor(ai - EDGE), math.floor(ai + EDGE)}:
            for v in {math.floor(bi - EDGE), math.floor(bi + EDGE)}:
                if 0 <= u < width and 0 <= v < height:
                    out.add(v * width + u)
    return np.asarray(sorted(out), np.int64), int(near.sum())


def _assert_ranges_equal(timg, jimg, edge):
    t = timg.ranges.numpy().reshape(-1)
    j = np.asarray(jimg.ranges).reshape(-1)
    keep = np.ones(len(t), bool)
    keep[edge] = False
    np.testing.assert_array_equal(t[keep], j[keep])
    assert np.isfinite(j).sum() > 100


@pytest.mark.parametrize("res_deg,width,height", [(2.0, 80, 60), (1.0, 360, 180)])
def test_spherical_projection_matches_jax(res_deg, width, height):
    pts, mask = _street()
    jc, tc = _both(pts, mask)
    res = math.radians(res_deg)
    jimg = jri.create_from_cloud(jc, res, width, height)
    timg = tri.create_from_cloud(tc, res, width, height)
    edge, n_near = _edge_pixels(pts, mask, False, res, width, height)
    assert n_near <= 0.005 * mask.sum()
    _assert_ranges_equal(timg, jimg, edge)
    np.testing.assert_array_equal(timg.center.numpy(), np.asarray(jimg.center))
    assert float(timg.angular_res) == float(jimg.angular_res) and not timg.planar


def test_planar_projection_and_pose_match_jax():
    """A pinhole image at 80 x 60, and a spherical image from a moved sensor
    (ranges within 1e-6 of their value: the two inverses of the pose may
    round apart)."""
    pts, mask = _street(1)
    jc, tc = _both(pts, mask)
    jimg = jri.create_planar_from_cloud(jc, 40.0, 80, 60)
    timg = tri.create_planar_from_cloud(tc, 40.0, 80, 60)
    edge, n_near = _edge_pixels(pts, mask, True, 40.0, 80, 60)
    assert n_near <= 0.005 * mask.sum()
    _assert_ranges_equal(timg, jimg, edge)
    assert timg.planar
    pose = np.eye(4, dtype=np.float32)
    c, s = math.cos(0.3), math.sin(0.3)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.5, 0.2, -1.0]
    jimg = jri.create_from_cloud(jc, math.radians(2.0), 80, 60, sensor_pose=jnp.asarray(pose))
    timg = tri.create_from_cloud(tc, math.radians(2.0), 80, 60, sensor_pose=torch.from_numpy(pose))
    t, j = timg.ranges.numpy(), np.asarray(jimg.ranges)
    both = np.isfinite(t) & np.isfinite(j)
    assert both.sum() >= 0.97 * np.isfinite(j).sum()
    assert np.abs(t[both] - j[both]).max() <= 1e-6 * np.abs(j[both]).max()


@pytest.mark.parametrize("planar", [False, True])
def test_to_cloud_matches_jax(planar):
    pts, mask = _street(2)
    jc, _ = _both(pts, mask)
    jimg = (jri.create_planar_from_cloud(jc, 40.0, 80, 60) if planar
            else jri.create_from_cloud(jc, math.radians(1.0), 360, 180))
    timg = interop.range_image_from_arrays(np.asarray(jimg.ranges), float(jimg.angular_res),
                                           np.asarray(jimg.center), np.asarray(jimg.sensor_pose),
                                           jimg.planar, device="cpu")
    jout, tout = jri.to_cloud(jimg), tri.to_cloud(timg)
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    assert (tout.width, tout.height) == (jout.width, jout.height)
    r = np.asarray(jimg.ranges).reshape(-1)
    m = np.asarray(jout.mask)
    err = np.abs(tout.xyz.numpy() - np.asarray(jout.xyz)).max(1)
    assert (err[m] <= 1e-6 * r[m]).all()
    assert (tout.xyz.numpy()[~m] == 0).all()


def _images():
    """The NARF tutorial's scene (a box in front of a wall, from the JAX
    package's tests) at 150 x 200, and the street at 180 x 360."""
    box = _narf_scenes.box_in_front_of_wall(None)
    yield jri.create_from_cloud(box, np.deg2rad(0.6), 200, 150)
    pts, mask = _street(3)
    jc, _ = _both(pts, mask)
    yield jri.create_from_cloud(jc, math.radians(1.0), 360, 180)


@pytest.fixture(scope="module")
def images():
    out = []
    for jimg in _images():
        timg = interop.range_image_from_arrays(np.asarray(jimg.ranges), float(jimg.angular_res),
                                               np.asarray(jimg.center),
                                               np.asarray(jimg.sensor_pose), jimg.planar,
                                               device="cpu")
        out.append((jimg, timg))
    return out


def test_borders_and_interest_match_jax(images):
    for jimg, timg in images:
        jb, tb = jnarf.extract_borders(jimg), tnarf.extract_borders(timg)
        np.testing.assert_array_equal(tb.border_type.numpy(), np.asarray(jb.border_type))
        np.testing.assert_array_equal(tb.border_score.numpy(), np.asarray(jb.border_score))
        assert (tb.border_type.numpy() == tnarf.BORDER_OBSTACLE).sum() > 10
        ti = tnarf.narf_interest_image(timg).numpy()
        ji = np.asarray(jnarf.narf_interest_image(jimg))
        assert np.abs(ti - ji).max() <= 1e-6


@pytest.mark.parametrize("kw", [{}, dict(max_keypoints=4000, min_interest=0.2, nms_radius=2)])
def test_keypoints_match_jax_in_every_slot(images, kw):
    """Ranked peaks, then the lowest-index pixels of score ``-inf``."""
    for jimg, timg in images:
        trc, tval, tvalid = tnarf.narf_keypoints(timg, **kw)
        jrc, jval, jvalid = jnarf.narf_keypoints(jimg, **kw)
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(trc.numpy(), np.asarray(jrc))
        np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
        assert 0 < tvalid.sum() <= len(tvalid)
        if kw:
            assert tvalid.sum() < len(tvalid)


@pytest.mark.parametrize("rotation_invariant", [True, False])
def test_descriptors_match_jax(images, rotation_invariant):
    for jimg, timg in images:
        jrc, _, _ = jnarf.narf_keypoints(jimg, max_keypoints=64)
        rc = np.asarray(jrc)
        td = tnarf.narf_descriptors(timg, torch.tensor(rc),
                                    rotation_invariant=rotation_invariant).numpy()
        jd = np.asarray(jnarf.narf_descriptors(jimg, jnp.asarray(rc),
                                               rotation_invariant=rotation_invariant))
        assert td.shape == (64, 36) and np.isfinite(td).all()
        assert np.abs(td - jd).max() <= 1e-6
