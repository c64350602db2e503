"""Device meshes on ``torch.distributed`` (the port's counterpart of
``strom/parallel/mesh.py``), and the process group they stand on.

The reference runs one process that addresses many devices
(``jax.devices()``). The port runs one process per card, as PyTorch does
on a host with several GPUs: each rank drives one card
(``torch.cuda.set_device(local_rank)`` before any CUDA call), ranks form a
process group, and a mesh is an array of global ranks with axis names,
over which a ``DeviceMesh`` builds one group a mesh axis. Axis convention
across the package: dp (data) / sp (sequence) / tp (tensor).

:func:`init_distributed` joins the group: NCCL for CUDA (created with
``device_id=``, so the communicator exists before any graph capture),
gloo for the CPU, and beside either two gloo groups for host-side
collectives: one for the calling thread's (the straggler table, the
scan's ``allgather``, the final barrier) and one for the epoch barriers,
which run wherever the prefetcher pulls its next batch. Two groups,
because collectives of one group must come in the same order on every
rank. Without a launcher it makes a world of 1 over an in-memory store.
Without any group the package runs on one device, as it did before
meshes existed.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

_host_group = None     # gloo: host collectives of the calling thread
_epoch_group = None    # gloo: epoch barriers (the prefetcher's pulls)
_device = torch.device("cpu")   # this rank's device, for every thread


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def init_distributed(device_type: str | None = None, *,
                     rank: int | None = None,
                     world_size: int | None = None,
                     init_method: str | None = None,
                     timeout_s: float = 600.0) -> None:
    """Join this process to the group, once (a second call does nothing).

    *rank* and *world_size* default to the launcher's ``RANK`` and
    ``WORLD_SIZE`` (``torch.distributed.run`` sets them, with
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), else 0 and 1.
    *init_method* (``tcp://localhost:<port>``) defaults to ``env://``
    where ``MASTER_ADDR`` is set; a world of 1 without one runs over an
    in-memory store. *device_type* ``"cuda"`` (the default where CUDA is
    available) sets this rank's card, ``LOCAL_RANK`` (else the rank), and
    makes an NCCL group; ``"cpu"`` a gloo one."""
    global _host_group, _epoch_group, _device
    if is_initialized():
        return
    env = os.environ
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    r = int(env.get("RANK", 0)) if rank is None else rank
    w = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    kw: dict = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if init_method is not None:
        kw["init_method"] = init_method
    elif "MASTER_ADDR" in env:
        kw["init_method"] = "env://"
    elif w == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError(f"a world of {w} needs init_method= or the "
                         "launcher's MASTER_ADDR and MASTER_PORT")
    if device_type == "cuda":
        _device = torch.device("cuda", int(env.get("LOCAL_RANK", r)))
        torch.cuda.set_device(_device)
        dist.init_process_group("nccl", rank=r, world_size=w,
                                device_id=_device, **kw)
        _host_group = dist.new_group(backend="gloo")
    elif device_type == "cpu":
        _device = torch.device("cpu")
        dist.init_process_group("gloo", rank=r, world_size=w, **kw)
        _host_group = dist.group.WORLD
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    _epoch_group = dist.new_group(backend="gloo")


def host_group():
    """The gloo group of host-side collectives from the calling thread."""
    if _host_group is None:
        raise RuntimeError("no process group: call init_distributed() first")
    return _host_group


def epoch_group():
    """The gloo group epoch barriers run on (and nothing else)."""
    if _epoch_group is None:
        raise RuntimeError("no process group: call init_distributed() first")
    return _epoch_group


def group_device() -> torch.device:
    """This rank's device: its card under NCCL, else the CPU. Fixed when
    the group is made, since the current CUDA device is a thread's own (a
    loader's threads start on card 0)."""
    return _device if is_initialized() else torch.device("cpu")


def shutdown() -> None:
    """Leave the group: a barrier on the host group first, so that no rank
    tears its connections down while a peer still finishes its last
    collective, then ``destroy_process_group``. Nothing without a group."""
    global _host_group, _epoch_group, _device
    if not is_initialized():
        return
    dist.barrier(group=_host_group)
    dist.destroy_process_group()
    _host_group = _epoch_group = None
    _device = torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis as this rank sees it, what ``lax.axis_index`` and
    ``lax.axis_size`` answer inside a ``shard_map``: this rank's *index* on
    the axis, its *size*, the global *ranks* along the axis through this
    rank (by index), and the axis's process *group* (None where the size is
    1: nothing to exchange)."""
    name: str
    index: int
    size: int
    ranks: tuple[int, ...]
    group: Any = None


class Mesh:
    """Named axes over a row-major array of global ranks: the counterpart of
    ``jax.sharding.Mesh``, whose ``devices`` are device objects where these
    are ranks. Where a process group exists, ``device_mesh`` is the
    ``DeviceMesh`` over the same ranks and names (built by every rank at
    once: it makes one group an axis). ``group(*axes)`` gives the group
    over several axes together, ``axis(name)`` one axis as this rank sees
    it."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d ranks for axes "
                             f"{self.axis_names}")
        self.device_type = group_device().type
        self._device_mesh = None
        self._groups: dict[tuple[str, ...], Any] = {}
        if is_initialized():
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(
                self.device_type, torch.from_numpy(self.devices),
                mesh_dim_names=self.axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_mesh(self):
        if self._device_mesh is None:
            raise RuntimeError("this mesh was built without a process group: "
                               "call init_distributed() before make_mesh()")
        return self._device_mesh

    def coords(self, r: int) -> tuple[int, ...] | None:
        """Rank *r*'s position in the mesh (None: not in it)."""
        hit = np.argwhere(self.devices == r)
        return tuple(int(c) for c in hit[0]) if len(hit) else None

    def axis_size(self, name: str) -> int:
        """The size of axis *name*; 1 where the mesh has no such axis."""
        return self.shape.get(name, 1)

    def axis_index(self, name: str) -> int:
        """This rank's index on axis *name*; 0 where the mesh has no such
        axis."""
        if name not in self.axis_names:
            return 0
        coords = self.coords(rank())
        if coords is None:
            raise ValueError(f"rank {rank()} is not in {self!r}")
        return coords[self.axis_names.index(name)]

    def group_ranks(self, *names: str) -> tuple[int, ...]:
        """The global ranks that share this rank's coordinates on every axis
        but *names*, in row-major order over *names* (axes the mesh lacks
        are left out): the members of ``group(*names)``."""
        coords = self.coords(rank())
        if coords is None:
            raise ValueError(f"rank {rank()} is not in {self!r}")
        index = tuple(slice(None) if a in names else c
                      for a, c in zip(self.axis_names, coords))
        return tuple(int(r) for r in self.devices[index].ravel())

    def group(self, *names: str):
        """The process group over the axes *names* together: the ranks that
        share this rank's coordinates on the other axes (e.g. ``("dp",
        "sp")``: the ranks of one tp coordinate). None where those axes hold
        one rank. One axis is the ``DeviceMesh``'s group; several make one
        group for each coordinate of the other axes, every rank creating
        every one at its first call (a collective call: every rank makes it
        in the same order)."""
        names = tuple(a for a in self.axis_names if a in names)
        if math.prod(self.shape[a] for a in names) == 1:
            return None
        if len(names) == 1:
            return self.device_mesh.get_group(names[0])
        if names not in self._groups:
            self.device_mesh   # raises without a process group
            keep = [self.axis_names.index(a) for a in names]
            other = [i for i in range(self.devices.ndim) if i not in keep]
            rows = self.devices.transpose(other + keep).reshape(
                -1, math.prod(self.devices.shape[i] for i in keep))
            mine = None
            for row in rows:
                g = dist.new_group([int(r) for r in row])
                if rank() in row:
                    mine = g
            self._groups[names] = mine
        return self._groups[names]

    def axis(self, name: str) -> AxisGroup:
        """Axis *name* as this rank sees it (size 1 where the mesh lacks
        it)."""
        size = self.axis_size(name)
        return AxisGroup(name, self.axis_index(name), size,
                         self.group_ranks(name) if size > 1 else (rank(),),
                         self.group(name))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.ravel().tolist()})"


def make_mesh(axes: dict[str, int] | None = None, *,
              devices: Sequence[int] | None = None) -> Mesh:
    """Build a Mesh from axis sizes, e.g. {"dp": 2, "tp": 4}.

    *devices* are global ranks (default: every rank of the group, or rank
    0 without one). Sizes must multiply to their count; an axis of size -1
    absorbs the remainder (like a reshape). With axes=None, a 1-axis "dp"
    mesh over all of them is returned."""
    devs = list(devices) if devices is not None else list(range(world_size()))
    n = len(devs)
    if axes is None:
        axes = {"dp": n}
    names = tuple(axes)
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                         f"{int(np.prod(sizes))} devices, have {n}")
    return Mesh(np.array(devs).reshape(sizes), names)


def factor_mesh(n: int, *, want_tp: int = 0) -> dict[str, int]:
    """Pick a sensible {dp, tp} factorisation of n devices: tp as requested if
    it divides n, else the largest power of two <= min(n, 8)."""
    if want_tp and n % want_tp == 0:
        tp = want_tp
    else:
        tp = 1
        while tp * 2 <= min(n, 8) and n % (tp * 2) == 0:
            tp *= 2
    return {"dp": n // tp, "tp": tp}
