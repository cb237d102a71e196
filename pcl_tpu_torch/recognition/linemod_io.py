"""LINEMOD templates in PCL's byte format (pcl::LINEMOD::saveTemplates /
loadTemplates; linemod.cpp serialize/deserialize,
sparse_quantized_multi_mod_template.h, region_xy.h).

Counterpart of ``pcl_tpu/recognition/linemod_io.py``, numpy host code copied
as it is: the files are byte-equal, and each package reads the other's.

Layout (little-endian, x86 widths)::

    int32   nr_templates
    per template:
        int32   num_features
        per feature:
            int32   x            (column, region-relative)
            int32   y            (row, region-relative)
            uint64  modality_index
            uint8   quantized_value  (a bit mask: 1 << bin)
        RegionXY: int32 x, int32 y, int32 width, int32 height

A template stores ``(dy, dx)`` offsets and bin indices; on reading, the
lowest set bit of a value is its bin.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from pcl_tpu_torch.recognition.linemod import LinemodTemplate


def save_templates(path: str, templates: List[LinemodTemplate],
                   region_xy=(0, 0)) -> None:
    """Write templates in the reference byte format (.lmt / .sqmmt)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(templates)))
        for t in templates:
            F = int(t.offsets.shape[0])
            f.write(struct.pack("<i", F))
            for i in range(F):
                dy, dx = int(t.offsets[i, 0]), int(t.offsets[i, 1])
                mod = int(t.modality[i])
                val = 1 << int(t.bins[i])
                f.write(struct.pack("<iiQB", dx, dy, mod, val))
            f.write(struct.pack("<iiii", region_xy[0], region_xy[1],
                                int(t.width), int(t.height)))


def load_templates(path: str) -> List[LinemodTemplate]:
    """Read templates written by this module OR by the reference's
    pcl::LINEMOD::saveTemplates."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from(fmt, data, off)
        off += struct.calcsize(fmt)
        return vals

    (n_templates,) = take("<i")
    out: List[LinemodTemplate] = []
    for _ in range(n_templates):
        (F,) = take("<i")
        offs = np.zeros((F, 2), np.int32)
        bins = np.zeros((F,), np.int32)
        mods = np.zeros((F,), np.int32)
        for i in range(F):
            x, y, mod, val = take("<iiQB")
            offs[i] = (y, x)
            mods[i] = mod
            # lowest set bit -> bin index (linemod.cpp:233 test order)
            bins[i] = (int(val) & -int(val)).bit_length() - 1 if val else 0
        rx, ry, w, h = take("<iiii")
        out.append(LinemodTemplate(offsets=offs, bins=bins, modality=mods,
                                   height=int(h), width=int(w)))
    return out
