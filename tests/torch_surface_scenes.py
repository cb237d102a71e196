"""Scenes for the surface and segmentation parity tests (numpy only, seeded):
a noisy sphere with its outward normals, a sphere on a floor patch, and a
``(JAX cloud, port CPU cloud)`` pair of the same arrays."""

import jax.numpy as jnp
import numpy as np

from pcl_tpu.core.cloud import Cloud as JCloud

from pcl_tpu_torch.core.cloud import make_cloud


def sphere(seed=0, n=800, radius=0.4, center=(0.0, 0.0, 2.0), noise=0.002):
    """``(xyz, normals)`` float32: ``n`` points on a sphere, radial noise."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius + noise * rng.normal(size=(n, 1))
    return (np.asarray(center) + r * d).astype(np.float32), d.astype(np.float32)


def sphere_on_floor(seed=0, n_sphere=600, n_floor=900, noise=0.002):
    """A sphere of 0.3 m resting on a 1.6 m floor patch (y up), with the
    true normals and an RGB per surface: ``(xyz, normals, rgb)``."""
    rng = np.random.default_rng(seed)
    xs, ns = sphere(seed + 1, n_sphere, 0.3, (0.0, 0.3, 0.0), noise)
    fl = np.stack([rng.uniform(-0.8, 0.8, n_floor), noise * rng.normal(size=n_floor),
                   rng.uniform(-0.8, 0.8, n_floor)], 1)
    xyz = np.concatenate([xs, fl]).astype(np.float32)
    nrm = np.concatenate([ns, np.tile([0.0, 1.0, 0.0], (n_floor, 1))]).astype(np.float32)
    rgb = np.concatenate([np.tile([0.9, 0.2, 0.1], (n_sphere, 1)),
                          np.tile([0.2, 0.3, 0.8], (n_floor, 1))])
    rgb = np.clip(rgb + 0.02 * rng.normal(size=rgb.shape), 0, 1).astype(np.float32)
    return xyz, nrm, rgb


def clouds(xyz, normals=None, rgb=None, capacity=None, mask=None):
    """The same points as a JAX cloud and a port cloud on the CPU; padding
    rows to ``capacity`` are invalid zeros."""
    n = len(xyz)
    cap = capacity or n
    pad = cap - n

    def grow(a):
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    m = grow(np.ones(n, bool) if mask is None else mask)
    attrs = {}
    if normals is not None:
        attrs["normal"] = grow(normals)
    if rgb is not None:
        attrs["rgb"] = grow(rgb)
    x = grow(xyz)
    jc = JCloud(xyz=jnp.asarray(x), mask=jnp.asarray(m),
                attrs={k: jnp.asarray(v) for k, v in attrs.items()})
    tc = make_cloud(x, m, attrs, device="cpu")
    return jc, tc
