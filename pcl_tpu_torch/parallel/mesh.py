"""Meshes of ranks, shards of padded tensors, and the collectives the sharded
functions reduce with.

Counterpart of ``pcl_tpu/parallel/mesh.py``. The JAX package is single
controller: one process places arrays on a ``jax.sharding.Mesh`` of devices
and ``shard_map`` bodies reduce with ``psum``/``pmax``/``pmin``,
``all_gather`` and ``ppermute``. The port is SPMD on ``torch.distributed``:
one process per rank, each rank with one device. Every sharded function takes
the same global inputs on every rank; a rank works on the rows that
``shard_cloud`` would place on its device (the row axis padded to a multiple
of the axis size, then cut into equal blocks in rank order) and returns what
the JAX output holds on that rank's device: replicated values whole, sharded
values as the rank's block. ``gather_shards`` reassembles blocks.

A :class:`Mesh` holds the process groups of its axes, this rank's
coordinates, its device and its backend. Transport follows the backend and is
decided once: NCCL moves device tensors; gloo moves host tensors, so a CUDA
tensor is copied to the host and back around every gloo collective (ranks that
share one card). A collective the backend refuses raises. Each helper counts
its calls and the bytes this rank hands to the backend in ``mesh.counts``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from pcl_tpu_torch.core.cloud import Cloud, _device

POINTS_AXIS = "points"

Axis = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of ranks: ``axis_names`` with ``axis_sizes`` (row-major in rank
    order), this rank's ``coords``, the groups of the axes this rank belongs
    to (keyed by the tuple of axis names they span, with the global ranks of
    their members in axis order), its ``device`` and ``backend``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], Tuple[Optional[dist.ProcessGroup], Tuple[int, ...]]]
    device: torch.device
    backend: str
    counts: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    owns_group: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def _axes(self, axis: Axis) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if list(axes) != [a for a in self.axis_names if a in axes]:
            raise ValueError(f"axes {axes} are not axes of {self.axis_names} in mesh order")
        return axes

    def group(self, axis: Axis):
        """``(process group, global ranks in axis order)`` of ``axis``."""
        return self.groups[self._axes(axis)]

    def close(self) -> None:
        """Destroy the one-rank group that this mesh's constructor formed in
        a process that had none; a group the caller brought up stays."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _rank_device(device) -> torch.device:
    """``device``, by default CUDA; a CUDA rank takes card
    ``local_rank % device_count``."""
    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return dev


def _one_rank_group(device) -> bool:
    """The group of a process that has none: one rank, NCCL on the card,
    gloo on the CPU, over an in-process store. Returns whether it formed one
    (the mesh built on it then owns it: ``Mesh.close`` destroys it)."""
    if dist.is_initialized():
        return False
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return True


def _grid_mesh(names: Sequence[str], sizes: Sequence[int], device,
               owns_group: bool = False) -> Mesh:
    """The mesh of every rank of the group, ``names`` row-major over rank
    order. Each rank creates every axis group in the same order, as
    ``dist.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    names, sizes = tuple(names), tuple(int(s) for s in sizes)
    coords, r = [], rank
    for s in reversed(sizes):
        coords.append(r % s)
        r //= s
    coords = tuple(reversed(coords))
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    groups = {names: (None, tuple(range(world)))}
    if len(names) > 1:
        for a, name in enumerate(names):
            # all groups along axis a: every coordinate of the other axes
            others = [range(s) if b != a else range(1) for b, s in enumerate(sizes)]
            for base in itertools.product(*others):
                members = tuple(sum(c * st for c, st in zip(base, strides)) + i * strides[a]
                                for i in range(sizes[a]))
                pg = dist.new_group(list(members))
                if rank in members:
                    groups[(name,)] = (pg, members)
    dev, backend = _rank_device(device), dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL process group moves CUDA tensors; this rank's device is {dev}")
    return Mesh(axis_names=names, axis_sizes=sizes, coords=coords, groups=groups,
                device=dev, backend=backend, owns_group=owns_group)


def make_mesh(n_devices: Optional[int] = None, axis: str = POINTS_AXIS, device=None) -> Mesh:
    """A 1-D mesh over every rank of the process group. A process without a
    group forms a one-rank group first, so one code path serves one rank and
    many; the mesh owns that group, and ``Mesh.close`` destroys it.
    ``n_devices``, when given, must be the group's size (each rank is one
    device). ``device``: this rank's device, by default its card."""
    owns = _one_rank_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks needs a process group of as many; "
                         f"this one has {world}")
    return _grid_mesh((axis,), (world,), device, owns_group=owns)


def _count(mesh: Mesh, kind: str, nbytes: int) -> None:
    c = mesh.counts.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


def _on_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A private copy of ``x`` where the backend can move it: the host under
    gloo, the device under NCCL."""
    if mesh.backend == "gloo":
        return x.detach().to("cpu", copy=True)
    return x.detach().clone()


def _axis_size(mesh: Mesh, axis: Axis) -> int:
    return len(mesh.group(axis)[1])


def _axis_index(mesh: Mesh, axis: Axis) -> int:
    """This rank's position along ``axis`` (row-major over a tuple)."""
    idx = 0
    for a in mesh._axes(axis):
        k = mesh.axis_names.index(a)
        idx = idx * mesh.axis_sizes[k] + mesh.coords[k]
    return idx


def _reduce(mesh: Mesh, x: torch.Tensor, axis: Axis, op, kind: str) -> torch.Tensor:
    pg, _ = mesh.group(axis)
    buf = _on_wire(mesh, x)
    _count(mesh, kind, buf.numel() * buf.element_size())
    dist.all_reduce(buf, op=op, group=pg)
    return buf.to(x.device)


def _psum(mesh: Mesh, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(mesh, x, axis, dist.ReduceOp.SUM, "psum")


def _pmax(mesh: Mesh, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(mesh, x, axis, dist.ReduceOp.MAX, "pmax")


def _pmin(mesh: Mesh, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(mesh, x, axis, dist.ReduceOp.MIN, "pmin")


def _all_gather(mesh: Mesh, x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on dim 0 in axis order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    pg, members = mesh.group(axis)
    # bool travels as bytes: not every backend moves bool tensors
    buf = _on_wire(mesh, x.to(torch.uint8) if x.dtype == torch.bool else x)
    _count(mesh, "all_gather", buf.numel() * buf.element_size())
    parts = [torch.empty_like(buf) for _ in members]
    dist.all_gather(parts, buf, group=pg)
    return torch.cat(parts).to(device=x.device, dtype=x.dtype)


def _ppermute(mesh: Mesh, xs: Sequence[torch.Tensor], axis: Axis,
              perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Send each of ``xs`` along the ``(source, destination)`` pairs of axis
    positions in ``perm`` and return what this rank receives, in one batch of
    point-to-point operations; a rank that receives nothing gets zeros. A
    ring of one rank is a local copy."""
    pg, members = mesh.group(axis)
    me = _axis_index(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    bufs = [_on_wire(mesh, x) for x in xs]
    outs = [torch.zeros_like(b) for b in bufs]
    _count(mesh, "ppermute", sum(b.numel() * b.element_size() for b in bufs) * len(dst))
    ops = []
    for d in dst:
        if d == me:
            for o, b in zip(outs, bufs):
                o.copy_(b)
        else:
            ops += [dist.P2POp(dist.isend, b, members[d], pg) for b in bufs]
    for s in src:
        if s != me:
            ops += [dist.P2POp(dist.irecv, o, members[s], pg) for o in outs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [o.to(x.device) for o, x in zip(outs, xs)]


def _shard(mesh: Mesh, x: torch.Tensor, axis: Axis = POINTS_AXIS) -> torch.Tensor:
    """This rank's block of the rows of ``x`` after padding the row count to a
    multiple of the axis size with zero rows (``shard_cloud``'s layout)."""
    n, i = _axis_size(mesh, axis), _axis_index(mesh, axis)
    cap = x.shape[0]
    if cap % n:
        x = torch.cat([x, x.new_zeros((n - cap % n,) + tuple(x.shape[1:]))])
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows].to(mesh.device)


def shard_cloud(cloud: Cloud, mesh: Mesh, axis: Axis = POINTS_AXIS) -> Cloud:
    """This rank's shard of ``cloud``: the capacity padded to a multiple of
    the axis size, then the rank's block of rows, on the rank's device."""
    n = _axis_size(mesh, axis)
    cap = cloud.capacity
    if cap % n:
        cloud = cloud.pad_to(cap + (-cap) % n)
    return Cloud(xyz=_shard(mesh, cloud.xyz, axis), mask=_shard(mesh, cloud.mask, axis),
                 attrs={k: _shard(mesh, v, axis) for k, v in cloud.attrs.items()},
                 width=0, height=1)


def replicate(tree, mesh: Mesh):
    """Tensors of ``tree`` (a tensor, or a list, tuple or dict of them) on
    this rank's device: every rank holds the whole value."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def gather_shards(mesh: Mesh, x: torch.Tensor, axis: Axis = POINTS_AXIS) -> torch.Tensor:
    """The whole value of a sharded output from every rank's block (for
    tests and checks)."""
    return _all_gather(mesh, x, axis)
