"""Packed-token ``.bin`` shards (the port's copy of
``strom/formats/rawbin.py``).

A shard is a flat on-disk array of token ids (fixed dtype). Records are
fixed-length windows of ``record_tokens`` tokens; shard boundaries never split
a record (the tail remainder of each shard is dropped, like the reference
drops partial trailing blocks). Consumer: the Llama pretrain pipeline.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from strom_torch.delivery.extents import Extent, ExtentList


@dataclasses.dataclass(frozen=True)
class TokenShardSet:
    """A set of packed-token shards addressed as one global record array."""

    paths: tuple[str, ...]
    record_tokens: int                 # tokens per record (seq_len + 1 for LM loss)
    dtype: np.dtype = np.dtype(np.int32)
    # per-shard byte sizes; None → stat
    shard_sizes: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if not self.paths:
            raise ValueError("need at least one shard")
        if self.record_tokens <= 0:
            raise ValueError("record_tokens must be positive")
        object.__setattr__(self, "paths", tuple(self.paths))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        sizes = self.shard_sizes
        if sizes is not None:
            sizes = tuple(sizes)  # keep the frozen dataclass hashable
            object.__setattr__(self, "shard_sizes", sizes)
            if len(sizes) != len(self.paths):
                raise ValueError("shard_sizes must match paths")
        counts = []
        for i, p in enumerate(self.paths):
            nbytes = sizes[i] if sizes is not None else os.stat(p).st_size
            counts.append(nbytes // self.record_bytes)
        object.__setattr__(self, "_records_per_shard", tuple(counts))
        starts = [0]
        for c in counts:
            starts.append(starts[-1] + c)
        object.__setattr__(self, "_record_starts", tuple(starts))

    @property
    def record_bytes(self) -> int:
        return self.record_tokens * self.dtype.itemsize

    @property
    def num_records(self) -> int:
        return self._record_starts[-1]  # type: ignore[attr-defined]

    def records_in_shard(self, shard: int) -> int:
        return self._records_per_shard[shard]  # type: ignore[attr-defined]

    def locate(self, record: int) -> tuple[str, int]:
        """(shard path, byte offset) of a global record index."""
        if not 0 <= record < self.num_records:
            raise IndexError(f"record {record} out of range [0, {self.num_records})")
        starts = self._record_starts  # type: ignore[attr-defined]
        # shards are typically few; linear scan is fine and branch-predictable
        shard = 0
        while starts[shard + 1] <= record:
            shard += 1
        return self.paths[shard], (record - starts[shard]) * self.record_bytes

    def extents(self, records: Sequence[int]) -> ExtentList:
        """Gather plan for a batch of (possibly shuffled) record indices.

        Adjacent records in the same shard coalesce into one extent, so a
        sequential batch is a handful of large reads.
        """
        out: list[Extent] = []
        for r in records:
            path, off = self.locate(int(r))
            if out and out[-1].path == path and \
                    out[-1].offset + out[-1].length == off:
                out[-1] = Extent(path, out[-1].offset,
                                 out[-1].length + self.record_bytes)
            else:
                out.append(Extent(path, off, self.record_bytes))
        return ExtentList(out)

    def batch_shape(self, n_records: int) -> tuple[int, int]:
        return (n_records, self.record_tokens)


def write_token_shard(ctx, path: str, tokens: np.ndarray, *,
                      fsync: bool = True) -> int:
    """Write a packed-token shard through the engine's write path
    (``ctx.pwrite``), the machinery that later reads it: *tokens* lands
    row-major exactly as :class:`TokenShardSet` slices it. An existing
    file is cut to the shard's size first. Returns bytes written."""
    arr = np.ascontiguousarray(tokens)
    truncate_to(path, arr.nbytes)
    return ctx.pwrite(path, arr.reshape(-1).view(np.uint8), fsync=fsync)


def truncate_to(path: str, nbytes: int) -> None:
    """Cut an existing *path* to *nbytes* (a write in place over a longer
    file would leave its old tail)."""
    if os.path.exists(path):
        os.truncate(path, nbytes)
