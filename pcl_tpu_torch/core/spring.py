"""Organized-cloud border expansion: pcl::common "spring" operations.

Counterpart of ``pcl_tpu/core/spring.py`` (reference common/spring.h): grow
an organized cloud by whole rows or columns filled with a constant point
(``expand_*``), copies of the edge (``duplicate_*``) or a mirror
(``mirror_*``), or remove them (``delete_*``). The JAX package pads with
numpy's ``edge`` and ``symmetric`` modes; the port gathers rows by index
with the same pattern (torch's ``reflect`` leaves the edge row out), which
repeats the reflection where the amount exceeds the side. On an expanded
border xyz takes the fill point, the mask True and attributes zeros.
"""

from __future__ import annotations

from typing import Dict

import torch

from pcl_tpu_torch.core.cloud import Cloud


def _grid(cloud: Cloud):
    h, w = cloud.height, cloud.width
    if h <= 0 or w <= 0 or h * w != cloud.capacity:
        raise ValueError("spring ops require an organized cloud")
    return h, w


def _views(cloud: Cloud, h: int, w: int):
    return (cloud.xyz.reshape(h, w, 3), cloud.mask.reshape(h, w),
            {k: v.reshape((h, w) + tuple(v.shape[1:])) for k, v in cloud.attrs.items()})


def _rebuild(xyz, mask, attrs: Dict[str, torch.Tensor], h: int, w: int) -> Cloud:
    return Cloud(xyz=xyz.reshape(-1, 3), mask=mask.reshape(-1),
                 attrs={k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in attrs.items()},
                 width=w, height=h)


def _source_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """Rows of a side of ``n`` that numpy's ``edge`` or ``symmetric`` pad by
    ``(before, after)`` copies: symmetric is periodic in ``2 n``."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return torch.clamp(i, 0, n - 1)
    m = torch.remainder(i, 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def _mirror(xyz, mask, attrs, pads, mode: str):
    """Gather along each axis by ``_source_index``."""
    for axis, (before, after) in enumerate(pads):
        if before == 0 and after == 0:
            continue
        idx = _source_index(xyz.shape[axis], before, after, mode, xyz.device)
        xyz = xyz.index_select(axis, idx)
        mask = mask.index_select(axis, idx)
        attrs = {k: v.index_select(axis, idx) for k, v in attrs.items()}
    return xyz, mask, attrs


def _constant(xyz, mask, attrs, pads, fill):
    """Pad with zeros; the border's xyz is ``fill``, its mask True."""
    (t, b), (l, r) = pads
    h, w = mask.shape
    h2, w2 = h + t + b, w + l + r
    dev = xyz.device
    f = torch.zeros(3, dtype=torch.float32, device=dev) if fill is None \
        else torch.as_tensor(fill, dtype=torch.float32, device=dev)
    xyz2 = f.expand(h2, w2, 3).clone()
    xyz2[t:t + h, l:l + w] = xyz
    mask2 = torch.ones((h2, w2), dtype=torch.bool, device=dev)
    mask2[t:t + h, l:l + w] = mask
    attrs2 = {}
    for k, v in attrs.items():
        a = v.new_zeros((h2, w2) + tuple(v.shape[2:]))
        a[t:t + h, l:l + w] = v
        attrs2[k] = a
    return xyz2, mask2, attrs2


def _border(cloud: Cloud, pads, mode: str, fill=None) -> Cloud:
    """Grow by ``pads = ((top, bottom), (left, right))`` in ``mode``:
    'constant' (the point ``fill``), 'edge' or 'symmetric'."""
    h, w = _grid(cloud)
    xyz, mask, attrs = _views(cloud, h, w)
    if mode == "constant":
        xyz2, mask2, attrs2 = _constant(xyz, mask, attrs, pads, fill)
    else:
        xyz2, mask2, attrs2 = _mirror(xyz, mask, attrs, pads, mode)
    return _rebuild(xyz2, mask2, attrs2, mask2.shape[0], mask2.shape[1])


def _pad(cloud: Cloud, amount: int, axis: int, mode: str, fill=None) -> Cloud:
    """``amount`` rows (axis 0) or columns (axis 1) on both sides."""
    pads = [(0, 0), (0, 0)]
    pads[axis] = (amount, amount)
    return _border(cloud, pads, mode, fill)


_POLICIES = {"constant": "constant", "replicate": "edge", "reflect": "symmetric"}


def copy_make_border(cloud: Cloud, top: int, bottom: int, left: int, right: int,
                     policy: str = "constant", value=None) -> Cloud:
    """Grow the organized cloud by ``(top, bottom)`` rows and ``(left,
    right)`` columns filled by ``policy``: 'constant' (the point
    ``value``), 'replicate' (edge) or 'reflect' (mirror)."""
    if policy not in _POLICIES:
        raise ValueError(f"unknown border policy {policy!r}")
    return _border(cloud, [(top, bottom), (left, right)], _POLICIES[policy], value)


def expand_rows(cloud: Cloud, fill, amount: int) -> Cloud:
    """Add ``amount`` rows of the fill point on top and bottom (spring.h:57)."""
    return _pad(cloud, amount, 0, "constant", fill)


def expand_columns(cloud: Cloud, fill, amount: int) -> Cloud:
    """Add ``amount`` columns of the fill point left and right (spring.h:69)."""
    return _pad(cloud, amount, 1, "constant", fill)


def duplicate_rows(cloud: Cloud, amount: int) -> Cloud:
    """Duplicate the top and bottom rows ``amount`` times (spring.h:78)."""
    return _pad(cloud, amount, 0, "edge")


def duplicate_columns(cloud: Cloud, amount: int) -> Cloud:
    """Duplicate the first and last columns ``amount`` times (spring.h:88)."""
    return _pad(cloud, amount, 1, "edge")


def mirror_rows(cloud: Cloud, amount: int) -> Cloud:
    """Mirror the top and bottom rows ``amount`` times (spring.h:97)."""
    return _pad(cloud, amount, 0, "symmetric")


def mirror_columns(cloud: Cloud, amount: int) -> Cloud:
    """Mirror the first and last columns ``amount`` times (spring.h:106)."""
    return _pad(cloud, amount, 1, "symmetric")


def _cut(cloud: Cloud, rows: slice, cols: slice) -> Cloud:
    h, w = _grid(cloud)
    xyz, mask, attrs = _views(cloud, h, w)
    mask2 = mask[rows, cols]
    return _rebuild(xyz[rows, cols], mask2, {k: v[rows, cols] for k, v in attrs.items()},
                    mask2.shape[0], mask2.shape[1])


def delete_rows(cloud: Cloud, amount: int) -> Cloud:
    """Remove ``amount`` rows from top and bottom (spring.h:115)."""
    h, _ = _grid(cloud)
    return _cut(cloud, slice(amount, h - amount), slice(None))


def delete_cols(cloud: Cloud, amount: int) -> Cloud:
    """Remove ``amount`` columns from left and right (spring.h:124)."""
    _, w = _grid(cloud)
    return _cut(cloud, slice(None), slice(amount, w - amount))
