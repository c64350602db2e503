"""Sharded read planning: a sharding → this process's contiguous byte
segments (the port's copy of ``strom/delivery/shard.py``).

Rows are row-major on disk: a shard that restricts only leading axes is a
handful of large contiguous reads; inner-axis slices (sequence-parallel
batches) decompose into per-row segments. The planner reads a sharding's
``addressable_devices_indices_map``: the port's ``TorchSharding`` holds one
device a process (one rank, one card), a ``NamedSharding`` every device
its process addresses.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Segment:
    """Copy file[file_offset : +length] → dest[dest_offset : +length]."""

    file_offset: int
    dest_offset: int
    length: int


def _normalize_index(index: tuple, shape: tuple[int, ...]) -> list[tuple[int, int]]:
    out = []
    for sl, dim in itertools.zip_longest(index, shape, fillvalue=slice(None)):
        if dim is None:
            raise ValueError("index longer than shape")
        if not isinstance(sl, slice):
            raise ValueError(f"only slice indices supported, got {sl!r}")
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise ValueError("strided shards not supported")
        out.append((start, stop))
    return out


def contiguous_segments(shape: tuple[int, ...], itemsize: int,
                        index: tuple) -> Iterator[Segment]:
    """Decompose a rectangular sub-block (tuple of slices) of a row-major array
    into contiguous (file_offset, dest_offset, length) segments."""
    if not shape:
        yield Segment(0, 0, itemsize)
        return
    bounds = _normalize_index(index, shape)
    # byte strides, row-major
    strides = [0] * len(shape)
    acc = itemsize
    for i in range(len(shape) - 1, -1, -1):
        strides[i] = acc
        acc *= shape[i]
    # k = number of leading dims that are NOT part of the trailing full block
    k = len(shape)
    while k > 0 and bounds[k - 1] == (0, shape[k - 1]):
        k -= 1
    if k == 0:
        total = math.prod(shape) * itemsize
        yield Segment(0, 0, total)
        return
    inner = strides[k - 1]  # bytes per index step along dim k-1
    start_k, stop_k = bounds[k - 1]
    run = (stop_k - start_k) * inner
    outer = [range(lo, hi) for lo, hi in bounds[: k - 1]]
    dest = 0
    for combo in itertools.product(*outer):
        off = sum(c * strides[i] for i, c in enumerate(combo)) + start_k * inner
        yield Segment(off, dest, run)
        dest += run


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    device: Any                    # torch.device
    local_shape: tuple[int, ...]
    nbytes: int
    segments: tuple[Segment, ...]  # file offsets relative to array start


def plan_sharded_read(global_shape: tuple[int, ...], dtype,
                      sharding) -> list[DevicePlan]:
    """Per-addressable-device read plans for a global array laid out row-major
    in the source at byte offset 0 (callers add their own base offset)."""
    itemsize = np.dtype(dtype).itemsize
    idx_map = sharding.addressable_devices_indices_map(tuple(global_shape))
    plans: list[DevicePlan] = []
    for device, index in idx_map.items():
        bounds = _normalize_index(index if index is not None else (), tuple(global_shape))
        local_shape = tuple(hi - lo for lo, hi in bounds)
        segs = tuple(contiguous_segments(tuple(global_shape), itemsize, index))
        nbytes = math.prod(local_shape) * itemsize if local_shape else itemsize
        assert sum(s.length for s in segs) == nbytes, "segment plan disagrees with shard size"
        plans.append(DevicePlan(device, local_shape, nbytes, segs))
    return plans


def dedupe_plans(plans: list[DevicePlan]) -> dict[tuple[Segment, ...], list[DevicePlan]]:
    """Group plans by identical segment sets (replicated shards are read once
    and copied to every replica)."""
    groups: dict[tuple[Segment, ...], list[DevicePlan]] = {}
    for p in plans:
        groups.setdefault(p.segments, []).append(p)
    return groups
