"""Multi-process runtime: bringing up the process group, hybrid (dcn, ici)
meshes, and a pose journal for restarts.

Counterpart of ``pcl_tpu/parallel/runtime.py``. This module creates no
process group when it is imported, so a worker imports it first.

- ``initialize_multihost``: ``torch.distributed.init_process_group`` from the
  JAX package's environment names (``PCL_TPU_COORDINATOR`` ``host:port``,
  ``PCL_TPU_NPROCS``, ``PCL_TPU_PROC_ID``) or an explicit ``init_method``
  (``tcp://...`` or ``file://...``). The backend is NCCL when every rank of
  the host has a card of its own, gloo on the CPU or when ranks share a card
  (``LOCAL_WORLD_SIZE`` ranks a host, the whole group unless set). A no-op
  returning False when nothing is set; safe to call twice, and raises when
  the process is already in a group of another size or rank.
- ``hybrid_mesh``: a 2-D (dcn, ici) mesh, host-major over rank order.
- ``CheckpointedPoses``: the append-only JSON-lines pose journal, in the JAX
  package's format, so each package resumes from the other's journal.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pcl_tpu_torch.core.cloud import _device
from pcl_tpu_torch.parallel.mesh import Mesh, _grid_mesh, _one_rank_group

ICI_AXIS = "ici"     # fast axis: the cards of one host
DCN_AXIS = "dcn"     # slow axis: across hosts


def _backend(device: torch.device, ranks_per_host: int) -> str:
    if device.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    init_method: Optional[str] = None,
    device=None,
) -> bool:
    """Join the process group. Returns True when it has more than one rank,
    False for a plain single-process run (nothing set: nothing done).

    ``coordinator_address`` (``host:port`` of rank 0), ``num_processes`` and
    ``process_id`` default to ``PCL_TPU_COORDINATOR``, ``PCL_TPU_NPROCS`` and
    ``PCL_TPU_PROC_ID``; ``init_method`` replaces the address. ``device`` is
    the kind of device the ranks compute on, by default the card; it decides
    the backend."""
    coordinator_address = coordinator_address or os.environ.get("PCL_TPU_COORDINATOR")
    if num_processes is None and "PCL_TPU_NPROCS" in os.environ:
        num_processes = int(os.environ["PCL_TPU_NPROCS"])
    if process_id is None and "PCL_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["PCL_TPU_PROC_ID"])
    if coordinator_address is None and num_processes is None and init_method is None:
        return False
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if (num_processes is not None and num_processes != world) or \
                (process_id is not None and process_id != rank):
            raise RuntimeError(f"this process is rank {rank} of a group of {world}, not rank "
                               f"{process_id} of {num_processes}")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize_multihost needs the number of processes and this "
                             "process's id (PCL_TPU_NPROCS, PCL_TPU_PROC_ID)")
        dev = _device(device)
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        backend = _backend(dev, per_host)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id))
                                  % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method or f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def hybrid_mesh(
    ici_axis: str = ICI_AXIS,
    dcn_axis: str = DCN_AXIS,
    dcn_size: Optional[int] = None,
    device=None,
) -> Mesh:
    """2-D mesh (dcn, ici): the inner axis spans the ranks of a host, the
    outer axis the hosts, host-major over rank order. ``dcn_size`` sets the
    number of host groups (by default the group's size over
    ``LOCAL_WORLD_SIZE``); the ranks must split evenly."""
    owns = _one_rank_group(device)
    n = dist.get_world_size()
    if dcn_size is None:
        dcn_size = n // int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % dcn_size:
        raise ValueError(f"{n} ranks don't split into {dcn_size} host groups")
    return _grid_mesh((dcn_axis, ici_axis), (dcn_size, n // dcn_size), device, owns_group=owns)


def mesh_info(mesh: Mesh) -> Dict[str, int]:
    return mesh.shape


class CheckpointedPoses:
    """Append-only pose journal for mapping runs that may be stopped.

    One JSON line per committed frame: ``{"frame": i, "pose": 16 floats}``.
    ``resume()`` returns ``(next_frame, last_pose)``; a torn last line (a
    crash in the middle of a write) is ignored."""

    def __init__(self, path: str):
        self.path = path

    def commit(self, frame: int, pose) -> None:
        if isinstance(pose, torch.Tensor):
            pose = pose.detach().cpu().numpy()
        rec = {"frame": int(frame),
               "pose": np.asarray(pose, np.float64).reshape(-1).tolist()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _records(self) -> List[dict]:
        out = []
        if not os.path.exists(self.path):
            return out
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break  # torn final line from a crash
        return out

    def resume(self) -> Tuple[int, np.ndarray]:
        """(next frame index to process, last committed pose [4,4])."""
        recs = self._records()
        if not recs:
            return 0, np.eye(4, dtype=np.float32)
        last = recs[-1]
        return int(last["frame"]) + 1, np.asarray(last["pose"], np.float32).reshape(4, 4)

    def poses(self) -> List[np.ndarray]:
        return [np.asarray(r["pose"], np.float32).reshape(4, 4) for r in self._records()]
