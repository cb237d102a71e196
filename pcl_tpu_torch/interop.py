"""State carried across from the JAX package.

Turns arrays that the JAX package produced, already converted to numpy by
the caller (``np.asarray(jax_array)``), into the port's objects, so that a
cloud or a cell table built there can be used here. This module reads only
numpy arrays and plain values; it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import Cloud, _device
from pcl_tpu_torch.search.cell_list import CellTable


def cloud_from_arrays(
    xyz: np.ndarray,
    mask: np.ndarray,
    attrs: Optional[Dict[str, np.ndarray]] = None,
    width: int = 0,
    height: int = 1,
    device=None,
) -> Cloud:
    """A Cloud with exactly these rows (padding and all), on ``device``
    (default CUDA)."""
    dev = _device(device)
    return Cloud(
        xyz=torch.tensor(np.asarray(xyz, np.float32), device=dev),
        mask=torch.tensor(np.asarray(mask, bool), device=dev),
        attrs={k: torch.tensor(np.asarray(v), device=dev)
               for k, v in (attrs or {}).items()},
        width=int(width),
        height=int(height),
    )


def cell_table_from_arrays(
    cell_size,
    table_size: int,
    cap: int,
    data: np.ndarray,
    count: np.ndarray,
    dims: Optional[Sequence[int]] = None,
    origin: Optional[np.ndarray] = None,
    device=None,
) -> CellTable:
    """A CellTable holding a table built elsewhere, queried as it is."""
    dev = _device(device)
    data = np.asarray(data, np.float32)
    if data.shape != (table_size + 1, cap * 4):
        raise ValueError(f"cell table data {data.shape} does not match "
                         f"table_size={table_size}, cap={cap}")
    return CellTable(
        cell_size=torch.tensor(np.float32(cell_size), device=dev),
        table_size=int(table_size),
        cap=int(cap),
        data=torch.tensor(data, device=dev),
        count=torch.tensor(np.asarray(count, np.int32), device=dev),
        dims=None if dims is None else tuple(int(d) for d in dims),
        origin=None if origin is None else torch.tensor(
            np.asarray(origin, np.float32), device=dev),
    )
