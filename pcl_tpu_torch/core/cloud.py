"""The Cloud container — the port's data model.

Counterpart of ``pcl_tpu/core/cloud.py``. A :class:`Cloud` holds fixed-size
padded tensors on one device:

- ``xyz``:   ``[capacity, 3] float32`` positions (padding rows are 0);
- ``mask``:  ``[capacity] bool`` validity;
- ``attrs``: named per-point tensors ``[capacity, ...]`` (normals, rgb, ...);
- ``width``/``height``: ints for organized clouds (``height == 1`` means
  unorganized).

Functions return new clouds; nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Standard attribute names (the same informal schema as pcl_tpu).
ATTR_NORMAL = "normal"          # [N, 3] f32
ATTR_CURVATURE = "curvature"    # [N] f32
ATTR_RGB = "rgb"                # [N, 3] f32 in [0, 1]
ATTR_INTENSITY = "intensity"    # [N] f32
ATTR_LABEL = "label"            # [N] i32


def _zero_invalid(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    mm = m.reshape((-1,) + (1,) * (v.ndim - 1))
    return torch.where(mm, v, torch.zeros((), dtype=v.dtype, device=v.device))


@dataclasses.dataclass(frozen=True)
class Cloud:
    """Fixed-capacity padded point cloud. ``xyz[i]`` is meaningful iff
    ``mask[i]``; padding rows are zero so masked reductions are plain sums."""

    xyz: torch.Tensor                   # [capacity, 3] float32
    mask: torch.Tensor                  # [capacity] bool
    attrs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    width: int = 0
    height: int = 1

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def count(self) -> torch.Tensor:
        """Number of valid points (a 0-d tensor on the cloud's device)."""
        return torch.sum(self.mask.to(torch.int32))

    @property
    def is_organized(self) -> bool:
        return self.height > 1

    def has(self, name: str) -> bool:
        return name in self.attrs

    def with_attrs(self, **new_attrs: torch.Tensor) -> "Cloud":
        attrs = dict(self.attrs)
        attrs.update(new_attrs)
        return dataclasses.replace(self, attrs=attrs)

    def without_attrs(self, *names: str) -> "Cloud":
        attrs = {k: v for k, v in self.attrs.items() if k not in names}
        return dataclasses.replace(self, attrs=attrs)

    def with_xyz(self, xyz: torch.Tensor) -> "Cloud":
        return dataclasses.replace(self, xyz=xyz)

    def with_mask(self, mask: torch.Tensor) -> "Cloud":
        """Intersect validity with ``mask`` and zero the rows that died."""
        new_mask = self.mask & mask
        return dataclasses.replace(self, xyz=_zero_invalid(self.xyz, new_mask),
                                   mask=new_mask)

    def take(self, indices: torch.Tensor, valid: Optional[torch.Tensor] = None) -> "Cloud":
        """Gather rows by index into a new unorganized cloud of
        ``len(indices)`` capacity. Indices are clipped to the capacity;
        ``valid`` further restricts which gathered rows are real."""
        idx = torch.clamp(indices.long(), 0, self.capacity - 1)
        m = self.mask[idx]
        if valid is not None:
            m = m & valid
        xyz = _zero_invalid(self.xyz[idx], m)
        attrs = {k: _zero_invalid(v[idx], m) for k, v in self.attrs.items()}
        return Cloud(xyz=xyz, mask=m, attrs=attrs, width=0, height=1)

    def pad_to(self, capacity: int) -> "Cloud":
        """Grow capacity with invalid zero rows."""
        cap = self.capacity
        if capacity < cap:
            raise ValueError(f"pad_to({capacity}) smaller than capacity {cap}")
        if capacity == cap:
            return self
        extra = capacity - cap

        def grow(v: torch.Tensor) -> torch.Tensor:
            return torch.cat([v, v.new_zeros((extra,) + tuple(v.shape[1:]))])

        return Cloud(xyz=grow(self.xyz), mask=grow(self.mask),
                     attrs={k: grow(v) for k, v in self.attrs.items()},
                     width=self.width, height=self.height)


def _device(device) -> torch.device:
    """``None`` means CUDA; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pcl_tpu_torch: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def make_cloud(
    xyz,
    mask=None,
    attrs: Optional[Dict[str, torch.Tensor]] = None,
    capacity: Optional[int] = None,
    width: int = 0,
    height: int = 1,
    device=None,
) -> Cloud:
    """Build a Cloud from ``[N, 3]`` points (tensor or array) on ``device``
    (default CUDA), optionally padded to ``capacity``."""
    dev = _device(device)
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
    n = xyz.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    attrs = {k: torch.as_tensor(v, device=dev) for k, v in (attrs or {}).items()}
    cloud = Cloud(xyz=_zero_invalid(xyz, mask), mask=mask, attrs=attrs,
                  width=width, height=height)
    if capacity is not None:
        cloud = cloud.pad_to(capacity)
    return cloud


def from_numpy(
    xyz: np.ndarray,
    attrs: Optional[Dict[str, np.ndarray]] = None,
    capacity: Optional[int] = None,
    drop_nonfinite: bool = True,
    width: int = 0,
    height: int = 1,
    device=None,
) -> Cloud:
    """Host arrays to a Cloud. Non-finite points become masked padding, and
    their float attributes are zeroed."""
    xyz = np.asarray(xyz, np.float32)
    mask = np.isfinite(xyz).all(axis=1) if drop_nonfinite else np.ones(len(xyz), bool)
    xyz = np.where(mask[:, None], xyz, 0.0).astype(np.float32)
    tattrs = {}
    for k, v in (attrs or {}).items():
        v = np.asarray(v)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        if drop_nonfinite and np.issubdtype(v.dtype, np.floating):
            v = np.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), v, np.zeros_like(v))
        tattrs[k] = v
    return make_cloud(xyz, mask, tattrs, capacity=capacity, width=width,
                      height=height, device=device)


def to_numpy(cloud: Cloud, compact: bool = True) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """``(xyz, attrs)`` as numpy; ``compact`` drops the padding rows."""
    xyz = cloud.xyz.cpu().numpy()
    mask = cloud.mask.cpu().numpy()
    attrs = {k: v.cpu().numpy() for k, v in cloud.attrs.items()}
    if compact:
        xyz = xyz[mask]
        attrs = {k: v[mask] for k, v in attrs.items()}
    return xyz, attrs


def concat(a: Cloud, b: Cloud) -> Cloud:
    """Concatenate two clouds; an attribute missing from one side is zeros."""
    keys = set(a.attrs) | set(b.attrs)

    def get(c: Cloud, other: Cloud, k: str) -> torch.Tensor:
        if k in c.attrs:
            return c.attrs[k]
        o = other.attrs[k]
        return o.new_zeros((c.capacity,) + tuple(o.shape[1:]))

    return Cloud(
        xyz=torch.cat([a.xyz, b.xyz]),
        mask=torch.cat([a.mask, b.mask]),
        attrs={k: torch.cat([get(a, b, k), get(b, a, k)]) for k in keys},
        width=0,
        height=1,
    )


def compact_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable permutation listing valid indices first, then invalid ones,
    and the valid count."""
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    return order, torch.sum(mask.to(torch.int32))


def compact(cloud: Cloud) -> Cloud:
    """Move valid points to the front (capacity unchanged)."""
    perm, _ = compact_indices(cloud.mask)
    return cloud.take(perm)
