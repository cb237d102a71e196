"""Morton keys of the linear octree.

Counterpart of ``morton_encode``/``_spread3`` in ``pcl_tpu/octree/linear.py``;
ICP's cell backend sorts its source by these keys when the target table is
hashed. The rest of the linear octree is ported with the octree slice.
"""

from __future__ import annotations

import torch


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` to every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_encode(cell: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` integer cell coords -> ``[...]`` int32 morton keys."""
    cell = cell.to(torch.int32)
    return (_spread3(cell[..., 0])
            | (_spread3(cell[..., 1]) << 1)
            | (_spread3(cell[..., 2]) << 2))
