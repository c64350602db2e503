"""Engine interface: submit/wait block reads (the port's copy of the
blocking half of ``strom/engine/base.py``).

==========================  =============================================
reference ioctl             Engine equivalent
==========================  =============================================
MAP_GPU_MEMORY              staging pool allocated at engine init
MEMCPY_SSD2GPU(_ASYNC)      Engine.submit / submit_raw / read_vectored
MEMCPY_WAIT                 Engine.wait
stat ioctl / /proc node     Engine.stats()
==========================  =============================================

The gather the delivery layer runs is :meth:`Engine.read_vectored`:
block_size chunking, queue_depth pipelining, per-chunk resubmits, and
short-read (EOF) accounting. The async token API, stats scopes, deadlines
and the retry backoff policy of the reference are not ported yet.
"""

from __future__ import annotations

import abc
import dataclasses
import errno
import os
from typing import Iterable, Sequence

import numpy as np

from strom_torch.config import StromConfig

_ENODATA = errno.ENODATA


@dataclasses.dataclass(frozen=True)
class ReadRequest:
    """One block read: file[offset : offset+length] → pool[buf_index][buf_offset:]."""

    file_index: int    # from Engine.register_file
    offset: int        # byte offset in file
    length: int        # bytes to read (<= buffer_size - buf_offset)
    buf_index: int     # staging pool slot
    tag: int           # caller-chosen completion tag
    buf_offset: int = 0


@dataclasses.dataclass(frozen=True)
class RawRead:
    """One block read straight into caller-owned memory: *dest* is a
    writable C-contiguous uint8 view that outlives the op (page-aligned for
    the O_DIRECT path)."""

    file_index: int
    offset: int
    length: int
    dest: np.ndarray
    tag: int


@dataclasses.dataclass(frozen=True)
class Completion:
    tag: int
    result: int        # bytes read (>=0) or negative errno


class EngineError(OSError):
    pass


class Engine(abc.ABC):
    """Owns the staging pool and the submission/completion machinery."""

    name: str = "abstract"

    def __init__(self, config: StromConfig):
        self.config = config
        self._vec_tag = 0

    # -- file registration (≙ CHECK_FILE handing an fd to the kmod) ---------
    @abc.abstractmethod
    def register_file(self, path: str, *, o_direct: bool | None = None) -> int:
        """Open *path* and return a file index for reads; o_direct=None uses
        the config / per-file probe."""

    @abc.abstractmethod
    def unregister_file(self, file_index: int) -> None: ...

    @abc.abstractmethod
    def file_uses_o_direct(self, file_index: int) -> bool: ...

    # -- staging pool (≙ MAP/LIST/INFO_GPU_MEMORY) --------------------------
    @abc.abstractmethod
    def buffer(self, buf_index: int) -> np.ndarray:
        """Zero-copy uint8 view of one pool slot (length == buffer_size)."""

    @property
    def num_buffers(self) -> int:
        return self.config.num_buffers

    @property
    def buffer_size(self) -> int:
        return self.config.buffer_size

    # -- submission / completion (≙ MEMCPY_SSD2GPU_ASYNC / MEMCPY_WAIT) -----
    @abc.abstractmethod
    def submit(self, requests: Sequence[ReadRequest]) -> int:
        """Queue pool reads; raises EngineError past queue_depth in flight."""

    @abc.abstractmethod
    def submit_raw(self, requests: Sequence[RawRead]) -> int:
        """Queue reads into caller-owned memory; all-or-nothing past
        queue_depth (EngineError EAGAIN)."""

    @abc.abstractmethod
    def wait(self, min_completions: int = 1,
             timeout_s: float | None = None) -> list[Completion]:
        """Block until >= min_completions ops retire (or timeout)."""

    @abc.abstractmethod
    def in_flight(self) -> int: ...

    @abc.abstractmethod
    def stats(self) -> dict: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- vectored gather: the delivery layer's hot path ---------------------
    def read_vectored(self, chunks: Sequence[tuple[int, int, int, int]],
                      dest: np.ndarray, *, retries: int = 1) -> int:
        """Execute a gather list: chunks of (file_index, file_offset,
        dest_offset, length) → dest, block_size-chunked and pipelined at
        queue_depth, each piece resubmitted up to *retries* times on error
        or short read. Returns total bytes read.

        Must not run concurrently with other submitters on this engine (the
        delivery layer serializes transfers). Raises EngineError; ENODATA
        means a short read (range extends past EOF). In-flight pieces are
        drained before any error propagates, so no worker writes into
        *dest* after this returns."""
        block = self.config.block_size
        qd = self.config.queue_depth
        d8 = dest.view(np.uint8).reshape(-1)
        # tag -> (file_idx, file_off, dest_off, want, attempts)
        pending: dict[int, tuple[int, int, int, int, int]] = {}
        redo: list[tuple[int, int, int, int, int]] = []
        it = ((fi, fo + p, do + p, min(block, ln - p), 0)
              for (fi, fo, do, ln) in chunks
              for p in range(0, ln, block))
        exhausted = False
        total = 0
        err: EngineError | None = None

        def submit(piece: tuple[int, int, int, int, int]) -> None:
            fi, fo, do, want, _ = piece
            tag = self._vec_tag
            self._vec_tag += 1
            self.submit_raw([RawRead(fi, fo, want, d8[do: do + want], tag)])
            pending[tag] = piece

        try:
            while True:
                while err is None and len(pending) < qd:
                    if redo:
                        submit(redo.pop())
                        continue
                    piece = None if exhausted else next(it, None)
                    if piece is None:
                        exhausted = True
                        break
                    submit(piece)
                if not pending:
                    break
                for c in self.wait(min_completions=1):
                    entry = pending.pop(c.tag, None)
                    if entry is None:
                        continue  # foreign tag: not ours to account
                    fi, fo, do, want, attempts = entry
                    if c.result == want:
                        total += want
                        continue
                    if err is None and attempts < retries:
                        redo.append((fi, fo, do, want, attempts + 1))
                        continue
                    if c.result < 0:
                        err = err or EngineError(
                            -c.result, f"read failed after {attempts + 1} "
                                       f"attempts: {os.strerror(-c.result)}")
                    else:
                        total += c.result
                        err = err or EngineError(
                            _ENODATA, f"short read ({c.result} < {want}) — "
                                      "file smaller than requested range?")
        except BaseException:
            while pending:  # no worker may write into dest after we return
                for c in self.wait(min_completions=1):
                    pending.pop(c.tag, None)
            raise
        if err is not None:
            raise err
        return total


def iter_chunks(offset: int, length: int, block: int) -> Iterable[tuple[int, int]]:
    """Split [offset, offset+length) into (offset, len) chunks of *block* bytes."""
    pos = offset
    end = offset + length
    while pos < end:
        take = min(block, end - pos)
        yield pos, take
        pos += take
