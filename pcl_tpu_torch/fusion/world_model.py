"""Host-side world model and TSDF volume checkpoints.

Counterpart of ``pcl_tpu/fusion/world_model.py``:
- ``WorldModel`` (PCL's ``kinfuLS::WorldModel``) keeps the x-slabs of TSDF
  that leave the cyclical volume and hands them back when the window returns,
  as dense numpy blocks keyed by their global voxel x-offset;
- ``save_tsdf``/``load_tsdf`` (PCL's ``TsdfVolume::save``/``load``)
  checkpoint a volume. The ``.npz`` layout is the JAX package's, so a file
  written by one package is read by the other.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.fusion.tsdf import TSDFVolume


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class WorldModel:
    """Unbounded TSDF world assembled from evicted x-slabs.

    Slabs are keyed by their global voxel x-offset (world_x = key *
    voxel_size from the world origin fixed at construction). Pushing a slab
    twice merges by the weighted average integration uses."""

    def __init__(self, voxel_size: float, world_origin=(0.0, 0.0, 0.0)):
        self.voxel_size = float(voxel_size)
        self.world_origin = np.asarray(world_origin, np.float32)
        self._slabs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _key(self, origin_x: float) -> int:
        return int(round((float(origin_x) - float(self.world_origin[0])) / self.voxel_size))

    def push_slab(self, origin_x: float, tsdf, weight) -> None:
        """Store an evicted slab whose first voxel plane sits at world x =
        ``origin_x`` (WorldModel::addSlice); tensors are copied to the host."""
        key = self._key(origin_x)
        t = _host(tsdf).astype(np.float32)
        w = _host(weight).astype(np.float32)
        if key in self._slabs:
            t0, w0 = self._slabs[key]
            wsum = w0 + w
            t = np.where(wsum > 0, (t0 * w0 + t * w) / np.maximum(wsum, 1e-9),
                         np.maximum(t0, t))
            w = np.minimum(wsum, 128.0)
        self._slabs[key] = (t, w)

    def fetch_slab(self, origin_x: float, shape) -> Tuple[np.ndarray, np.ndarray]:
        """The slab entering the window at ``origin_x``
        (WorldModel::getExistingData); empty (tsdf 1, weight 0) if unseen."""
        key = self._key(origin_x)
        if key in self._slabs:
            t, w = self._slabs[key]
            if t.shape == tuple(shape):
                return t, w
        return np.ones(shape, np.float32), np.zeros(shape, np.float32)

    @property
    def n_slabs(self) -> int:
        return len(self._slabs)

    def extract_points(self, iso_band: float = 0.25) -> np.ndarray:
        """All near-surface voxel centres across stored slabs, ``[N, 3]``
        world coordinates."""
        out = []
        for key, (t, w) in sorted(self._slabs.items()):
            gx, gy, gz = np.nonzero((np.abs(t) < iso_band) & (w > 0))
            pts = np.stack([gx + key, gy, gz], axis=-1).astype(np.float32)
            out.append(self.world_origin + (pts + 0.5) * self.voxel_size)
        if not out:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(out, axis=0)

    def save(self, path: str) -> None:
        keys = sorted(self._slabs)
        np.savez_compressed(
            path,
            voxel_size=self.voxel_size,
            world_origin=self.world_origin,
            keys=np.asarray(keys, np.int64),
            **{f"t{k}": self._slabs[k][0] for k in keys},
            **{f"w{k}": self._slabs[k][1] for k in keys},
        )

    @classmethod
    def load(cls, path: str) -> "WorldModel":
        z = np.load(path)
        wm = cls(float(z["voxel_size"]), z["world_origin"])
        for k in z["keys"]:
            wm._slabs[int(k)] = (z[f"t{int(k)}"], z[f"w{int(k)}"])
        return wm


def save_tsdf(path: str, vol: TSDFVolume) -> None:
    """Checkpoint a TSDF volume (TsdfVolume::save)."""
    np.savez_compressed(
        path,
        tsdf=np.asarray(_host(vol.tsdf), np.float32),
        weight=np.asarray(_host(vol.weight), np.float32),
        origin=np.asarray(_host(vol.origin), np.float32),
        voxel_size=np.float32(_host(vol.voxel_size)),
        trunc=np.float32(_host(vol.trunc)),
    )


def load_tsdf(path: str, device=None) -> TSDFVolume:
    """Resume a TSDF volume (TsdfVolume::load) on ``device`` (default CUDA)."""
    dev = _device(device)
    z = np.load(path)
    return TSDFVolume(
        tsdf=torch.from_numpy(z["tsdf"]).to(dev),
        weight=torch.from_numpy(z["weight"]).to(dev),
        origin=torch.from_numpy(z["origin"]).to(dev),
        voxel_size=torch.tensor(np.float32(z["voxel_size"]), device=dev),
        trunc=torch.tensor(np.float32(z["trunc"]), device=dev),
    )
