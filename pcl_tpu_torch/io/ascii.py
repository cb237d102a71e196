"""Whitespace-separated XYZ[+extras] reader and writer.

Counterpart of ``pcl_tpu/io/ascii.py``. One extra column is ``intensity``,
three are ``rgb`` (``normal`` when ``columns`` names the fourth ``nx``), any
other number goes to ``extra``.
"""

from __future__ import annotations

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, from_numpy, to_numpy


def load(path, capacity=None, columns=("x", "y", "z"), device=None) -> Cloud:
    data = np.loadtxt(path, dtype=np.float32, ndmin=2)
    if data.shape[1] < 3:
        raise ValueError(f"need >= 3 columns, got {data.shape[1]}")
    xyz = data[:, :3]
    attrs = {}
    extra = data[:, 3:]
    if extra.shape[1] == 1:
        attrs["intensity"] = extra[:, 0]
    elif extra.shape[1] == 3:
        attrs["normal" if tuple(columns[3:4]) == ("nx",) else "rgb"] = extra
    elif extra.shape[1] > 0:
        attrs["extra"] = extra
    return from_numpy(xyz, attrs, capacity=capacity, device=device)


def save(path, cloud: Cloud) -> None:
    xyz, _ = to_numpy(cloud, compact=True)
    np.savetxt(path, xyz, fmt="%.9g")
