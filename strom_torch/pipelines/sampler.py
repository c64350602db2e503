"""Epoch-shuffled, checkpointable batch sampling — the port's copy of
``strom/pipelines/sampler.py``, so the same seed gives the same order.
The loader state is (dataset fingerprint, epoch, cursor, seed), a small
blob, so a resumed run replays no data.

The sampler is deterministic given (seed, epoch): every host computes the
same global permutation, with no coordinator traffic.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SamplerState:
    """Position of a loader in its (infinite) epoch stream."""

    epoch: int = 0
    batch_in_epoch: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SamplerState":
        return cls(epoch=int(d["epoch"]), batch_in_epoch=int(d["batch_in_epoch"]),
                   seed=int(d["seed"]))


class EpochShuffleSampler:
    """Yields global record-index batches, reshuffling each epoch.

    Deterministic: permutation of epoch e is Philox(seed, e) — identical on
    every host, resumable mid-epoch by fast-forwarding the cursor (no stored
    RNG state needed).
    """

    def __init__(self, num_records: int, batch: int, *, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 state: SamplerState | None = None):
        if num_records <= 0:
            raise ValueError("num_records must be positive")
        if batch <= 0:
            raise ValueError("batch must be positive")
        if not drop_last and num_records % batch:
            raise ValueError("drop_last=False unsupported: ragged final batch "
                             "would change the batch shape")
        if batch > num_records:
            raise ValueError(f"batch {batch} > num_records {num_records}")
        self.num_records = num_records
        self.batch = batch
        self.shuffle = shuffle
        # COPY the caller's state: iteration mutates self.state in place,
        # and aliasing the caller's object would move the caller's resume
        # point along with the prefetch window
        self.state = dataclasses.replace(state) if state is not None \
            else SamplerState(seed=seed)
        # permutation memo for peek(): the readahead thread polls the
        # upcoming window every few ms. Two epochs are kept: near an epoch
        # boundary every peek needs both perm(e) and perm(e+1)
        self._peek_perms: dict[int, np.ndarray] = {}

    @property
    def batches_per_epoch(self) -> int:
        return self.num_records // self.batch

    def _perm(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_records, dtype=np.int64)
        rng = np.random.Generator(np.random.Philox(key=[self.state.seed, epoch]))
        return rng.permutation(self.num_records).astype(np.int64)

    def _perm_cached(self, epoch: int) -> np.ndarray:
        perm = self._peek_perms.get(epoch)
        if perm is None:
            perm = self._perm(epoch)
            # keep this epoch and its neighbour; drop anything older
            self._peek_perms = {e: p for e, p in self._peek_perms.items()
                                if e >= epoch - 1}
            self._peek_perms[epoch] = perm
        return perm

    def peek(self, n: int) -> list[np.ndarray]:
        """The next *n* index batches from the current cursor, without
        advancing it: the window the epoch-aware readahead
        (``delivery/hotcache.py``) warms. Crosses the epoch boundary, since
        the permutation is deterministic in (seed, epoch).

        An advisory read: the consumer's thunk generator advances ``state``
        concurrently, and a torn (epoch, cursor) read at the boundary only
        shifts which batches warm."""
        epoch, i = self.state.epoch, self.state.batch_in_epoch
        out: list[np.ndarray] = []
        while len(out) < n:
            if i >= self.batches_per_epoch:
                epoch += 1
                i = 0
            perm = self._perm_cached(epoch)
            out.append(perm[i * self.batch: (i + 1) * self.batch])
            i += 1
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        """Infinite stream of batches; advance `state` as a side effect so a
        checkpoint taken between batches resumes exactly after the last one."""
        while True:
            perm = self._perm(self.state.epoch)
            while self.state.batch_in_epoch < self.batches_per_epoch:
                i = self.state.batch_in_epoch
                batch = perm[i * self.batch: (i + 1) * self.batch]
                self.state.batch_in_epoch = i + 1
                yield batch
            self.state.epoch += 1
            self.state.batch_in_epoch = 0


def dataset_fingerprint(paths: tuple[str, ...], ctx=None) -> dict:
    """Identity of the shard list a loader state is valid against. Paths the
    *ctx* aliases to striped sets (``register_striped``) fingerprint by their
    striped logical size: they need not exist on disk."""
    def size(p: str) -> int:
        sf = ctx.striped_source(p) if ctx is not None else None
        return os.stat(p).st_size if sf is None else sf.size

    return {"paths": list(paths), "sizes": [size(p) for p in paths]}


def save_loader_state(path: str, state: SamplerState,
                      fingerprint: dict, extra: dict | None = None) -> None:
    blob = {"version": 1, "sampler": state.to_dict(),
            "fingerprint": fingerprint, "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)


def load_loader_state(path: str, fingerprint: dict | None = None
                      ) -> tuple[SamplerState, dict]:
    """Returns (sampler state, extra). If *fingerprint* is given, it must
    match the saved one — resuming against a changed dataset is an error, not
    a silent skew."""
    with open(path) as f:
        blob = json.load(f)
    if blob.get("version") != 1:
        raise ValueError(f"unknown loader-state version {blob.get('version')}")
    if fingerprint is not None and blob["fingerprint"] != fingerprint:
        raise ValueError(
            "loader state was saved against a different dataset "
            f"(saved {len(blob['fingerprint']['paths'])} shards, "
            f"now {len(fingerprint['paths'])}); refusing to resume")
    return SamplerState.from_dict(blob["sampler"]), blob.get("extra", {})
