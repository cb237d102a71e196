"""Scenes and float64 margin helpers shared by the descriptor parity tests
(``test_torch_shot.py``, ``test_torch_descriptors.py``,
``test_torch_global_desc.py``, ``test_torch_color_features.py``,
``test_torch_keypoints.py``).

A scene is a small street corner: ground, a facade, a box (a car), a pole
and a ball, sampled at random with 5 mm of noise, with normals from the JAX
package that both packages are given, a reflectance-like intensity and an
RGB with gradients. The float64 margin checks that decide which rows are
compared are in ``float64_cuts.py``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from pcl_tpu import features as jfeat
from pcl_tpu.core.cloud import Cloud as JCloud

from pcl_tpu_torch.core.cloud import Cloud as TCloud


def street_corner(seed=0, n=1500):
    """``n`` points of a 2 m street corner, 5 mm noise, float32."""
    rng = np.random.default_rng(seed)
    m = n // 6
    g = rng.uniform([-1, 0, -1], [1, 0, 1], (m, 3))                    # ground y = 0
    w = rng.uniform([-1, 0, 1], [1, 1.2, 1], (m, 3))                   # facade z = 1
    # a box 0.8 x 0.4 x 0.5 standing on the ground
    face = rng.integers(0, 5, m)
    u = rng.uniform(-1, 1, (m, 2))
    half = np.array([0.4, 0.2, 0.25])
    box = np.zeros((m, 3))
    for f, (ax, side) in enumerate(((0, 1), (0, -1), (2, 1), (2, -1), (1, 1))):
        sel = face == f
        others = [a for a in range(3) if a != ax]
        box[sel, ax] = side * half[ax]
        box[sel, others[0]] = u[sel, 0] * half[others[0]]
        box[sel, others[1]] = u[sel, 1] * half[others[1]]
    box += np.array([-0.3, 0.2, 0.1])
    t = rng.uniform(0, 2 * np.pi, m)
    pole = np.stack([0.6 + 0.06 * np.cos(t), rng.uniform(0, 1.1, m),
                     -0.4 + 0.06 * np.sin(t)], 1)
    s = rng.normal(size=(n - 4 * m, 3))
    ball = 0.2 * s / np.linalg.norm(s, axis=1, keepdims=True) + np.array([0.5, 0.2, 0.5])
    pts = np.concatenate([g, w, box, pole, ball])
    return (pts + rng.normal(scale=0.005, size=pts.shape)).astype(np.float32)


def intensity_of(xyz):
    """A reflectance per surface with a falloff and a stripe pattern."""
    r = np.linalg.norm(xyz - np.array([0.0, 1.5, -2.0]), axis=1)
    stripes = 0.2 * np.sin(6.0 * xyz[:, 0]) * np.cos(4.0 * xyz[:, 2])
    return (0.6 + stripes + 0.1 * xyz[:, 1]) / (1.0 + 0.1 * r * r)


def rgb_of(xyz):
    """Colour with gradients, in [0, 1]."""
    r = 0.5 + 0.4 * np.sin(3.0 * xyz[:, 0] + 1.0)
    g = 0.5 + 0.4 * np.cos(2.5 * xyz[:, 2])
    b = 0.5 + 0.4 * np.sin(2.0 * xyz[:, 1] + xyz[:, 0])
    return np.stack([r, g, b], 1).astype(np.float32)


def clouds(xyz, k=12, capacity=None, viewpoint=(0.0, 3.0, -3.0), attrs=True):
    """The JAX cloud and the port's (CPU) cloud of ``xyz`` with the JAX
    package's normals and curvature, and intensity and rgb, padded to
    ``capacity``."""
    n = len(xyz)
    cap = capacity or n
    pad = np.zeros((cap, 3), np.float32)
    pad[:n] = xyz
    mask = np.arange(cap) < n
    jc = JCloud(xyz=jnp.asarray(pad), mask=jnp.asarray(mask))
    jc = jfeat.estimate_normals(jc, k=k, viewpoint=jnp.asarray(viewpoint, jnp.float32))
    a = {key: np.array(v) for key, v in jc.attrs.items()}
    if attrs:
        inten = np.zeros(cap, np.float32)
        inten[:n] = intensity_of(xyz)
        rgb = np.zeros((cap, 3), np.float32)
        rgb[:n] = rgb_of(xyz)
        a.update(intensity=inten, rgb=rgb)
    jc = JCloud(xyz=jnp.asarray(pad), mask=jnp.asarray(mask),
                attrs={key: jnp.asarray(v) for key, v in a.items()})
    tc = TCloud(xyz=torch.from_numpy(pad), mask=torch.from_numpy(mask),
                attrs={key: torch.from_numpy(v) for key, v in a.items()})
    return jc, tc


def count_line(name, firm):
    """What a test prints about the rows it left out."""
    return f"{name}: {int(firm.sum())} of {len(firm)} rows firm, {int((~firm).sum())} left out"
