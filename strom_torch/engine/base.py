"""Engine interface: submit/wait block reads, a blocking vectored gather
and its async twin (the port's copy of ``strom/engine/base.py``).

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
short-read (EOF) accounting; the io_uring engine runs the whole gather in
C++ instead. :meth:`Engine.submit_vectored` starts the same gather
asynchronously and returns a :class:`StreamToken`; :meth:`Engine.poll`
reports chunks as they retire, so a caller can work on early chunks while
later ones are in flight. ``op="write"`` runs the same machine in reverse
(:meth:`Engine.write_vectored`): each chunk writes the buffer's bytes to a
file registered ``writable=True``. Each op's submit-to-completion latency
goes to the ``engine_op_lat`` histogram of the scope :meth:`Engine.set_scope`
installed. Request deadlines and the retry backoff policy of the reference
are not ported yet: a failed piece is resubmitted at once, up to
``retries`` times, as ``read_vectored`` does.
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
import errno
import os
import time
from typing import Iterable, Sequence

import numpy as np

from strom_torch.config import StromConfig

_ENODATA = errno.ENODATA
_ECANCELED = errno.ECANCELED


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
class RawWrite:
    """One block write from caller-owned memory to file[offset:offset+length)
    (the write twin of :class:`RawRead`): *src* is a C-contiguous uint8 view
    that outlives the op (page-aligned for the O_DIRECT path), and the file
    was registered with ``writable=True``."""

    file_index: int
    offset: int
    length: int
    src: np.ndarray
    tag: int

    @property
    def dest(self) -> np.ndarray:
        # the op's buffer whatever its direction: engine internals
        # (keepalives, the python workers) address it without branching
        return self.src


@dataclasses.dataclass(frozen=True)
class Completion:
    tag: int
    result: int        # bytes read or written (>=0) or negative errno


@dataclasses.dataclass(frozen=True)
class ChunkCompletion:
    """One chunk of an async gather retired: *index* is its position in the
    chunk list given to :meth:`Engine.submit_vectored`; *result* is the
    chunk's byte count, or a negative errno when it failed (retries spent,
    or a short read: -ENODATA)."""

    index: int
    result: int


class EngineError(OSError):
    pass


class EngineStallError(EngineError):
    """No completion arrived within ``engine_wait_timeout_s`` while ops
    were in flight; names the stuck tags."""

    def __init__(self, timeout_s: float, tags: Sequence, where: str):
        self.stuck_tags = tuple(tags)
        shown = ", ".join(str(t) for t in self.stuck_tags[:8])
        if len(self.stuck_tags) > 8:
            shown += f", ... ({len(self.stuck_tags)} total)"
        super().__init__(
            errno.ETIMEDOUT,
            f"engine stall in {where}: no completion for {timeout_s:.1f}s "
            f"with {len(self.stuck_tags)} op(s) in flight (tags: {shown})")


class StreamToken:
    """One in-flight vectored gather (:meth:`Engine.submit_vectored`): which
    chunks retired, which block-size pieces are in flight, and each chunk's
    result. Not thread-safe: one thread drives poll/drain per token."""

    __slots__ = ("chunks", "retries", "fail_fast", "op", "_d8", "_left",
                 "_results", "_pending", "_pieces", "_backlog", "_exhausted",
                 "_ready", "bytes_done", "cancelled", "inflight_peak", "_err")

    def __init__(self, chunks: Sequence[tuple[int, int, int, int]],
                 dest: np.ndarray, block: int, retries: int,
                 fail_fast: bool = True, op: str = "read"):
        self.chunks = list(chunks)
        self.retries = retries
        # "read" gathers file -> dest; "write" scatters dest -> file (dest
        # is then the source). Only the op built per piece differs
        self.op = op
        # True (read_vectored's contract): the first failed chunk stops
        # feeding the rest. False: a failed chunk retires as a negative
        # ChunkCompletion and the rest of the gather keeps flowing
        self.fail_fast = fail_fast
        self._d8 = dest.view(np.uint8).reshape(-1)
        # bytes of each chunk not yet landed; a chunk retires at 0
        self._left = [ln for (_, _, _, ln) in self.chunks]
        self._results: list[int | None] = [None] * len(self.chunks)
        # tag -> (chunk_idx, file_idx, file_off, dest_off, want, attempts)
        self._pending: dict[int, tuple[int, int, int, int, int, int]] = {}
        self._pieces = ((ci, fi, fo + p, do + p, min(block, ln - p), 0)
                        for ci, (fi, fo, do, ln) in enumerate(self.chunks)
                        for p in range(0, ln, block))
        # pieces bounced by a full queue or due for a retry: resubmitted
        # before the iterator advances
        self._backlog: list[tuple[int, int, int, int, int, int]] = []
        self._exhausted = not self.chunks
        self._ready: list[ChunkCompletion] = []
        self.bytes_done = 0
        self.cancelled = False
        self.inflight_peak = 0
        self._err: EngineError | None = None

    @property
    def done(self) -> bool:
        return (self._exhausted and not self._backlog
                and not self._pending) or self.cancelled

    def pending_chunk_indices(self) -> set:
        """Chunk indices with at least one piece in flight right now."""
        return {p[0] for p in self._pending.values()}

    @property
    def error(self) -> EngineError | None:
        return self._err


class Engine(abc.ABC):
    """Owns the staging pool and the submission/completion machinery."""

    name: str = "abstract"
    # True: the engine serializes gathers itself (per ring), so the delivery
    # layer must not wrap each transfer in its own lock
    concurrent_gathers: bool = False

    def __init__(self, config: StromConfig):
        self.config = config
        self._vec_tag = 0
        # async tokens not yet drained or cancelled: close() cancels them
        self._live_tokens: list = []

    # -- file registration (≙ CHECK_FILE handing an fd to the kmod) ---------
    @abc.abstractmethod
    def register_file(self, path: str, *, o_direct: bool | None = None,
                      writable: bool = False) -> int:
        """Open *path* and return a file index for reads; o_direct=None uses
        the config / per-file probe. writable=True opens it read-write, so
        the index also takes :class:`RawWrite` ops and ``op="write"``
        gathers; the caller creates the file first."""

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

    def buffer_info(self) -> dict:
        """The staging pool's geometry (≙ LIST/INFO_GPU_MEMORY)."""
        return {
            "num_buffers": self.num_buffers,
            "buffer_size": self.buffer_size,
            "total_bytes": self.num_buffers * self.buffer_size,
            "engine": self.name,
        }

    def register_dest(self, arr: np.ndarray) -> int:
        """Register a caller slab so gathers into it can use pre-pinned
        fixed buffers. -1 = not supported by this engine (the default);
        reads work identically either way."""
        return -1

    def unregister_dest(self, arr: np.ndarray) -> None:
        pass

    def unregister_dest_addr(self, addr: int) -> None:
        pass

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

    # -- per-op telemetry scope --------------------------------------------
    # The delivery context installs its scope here, and the scheduler the
    # scope of the tenant holding an exclusive grant, so per-op latency
    # (the engine_op_lat histogram, submit to completion) lands per tenant
    # while the unlabelled aggregate stays the whole engine's. The
    # reference's engine_inflight gauge is left out: reading the in-flight
    # count takes the engine's lock twice an op.
    def set_scope(self, scope) -> None:
        """Install the telemetry scope (a ``StatsRegistry`` or
        ``ScopedStats``) per-op accounting writes through."""
        self._op_scope = scope

    @property
    def op_scope(self):
        sc = getattr(self, "_op_scope", None)
        if sc is None:
            from strom_torch.utils.stats import global_stats

            return global_stats
        return sc

    def _note_submitted(self, requests: Sequence) -> None:
        """Stamp each op's submit time."""
        m = getattr(self, "_op_submit_t", None)
        if m is None:
            m = self._op_submit_t = {}
        t = time.perf_counter()
        for r in requests:
            m[r.tag] = t

    def _note_completed(self, completions: Sequence) -> None:
        m = getattr(self, "_op_submit_t", None)
        if m:
            t = time.perf_counter()
            h = self.op_scope.histogram("engine_op_lat")
            for c in completions:
                t0 = m.pop(c.tag, None)
                if t0 is not None:
                    h.observe_us((t - t0) * 1e6)

    @property
    def wait_timeout_s(self) -> float:
        """The stall watchdog: the longest a gather path waits for a
        completion before raising EngineStallError."""
        return self.config.engine_wait_timeout_s

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

    # -- async vectored gather: completion-driven submission ---------------
    # A live token owns the engine's gather path as a read_vectored call
    # does: the delivery layer holds its engine lock from submit_vectored
    # until the token drains or is cancelled (per-ring locks on the multi
    # engine). One thread drives poll/drain per token.

    def submit_vectored(self, chunks: Sequence[tuple[int, int, int, int]],
                        dest: np.ndarray, *, retries: int = 1,
                        fail_fast: bool = True,
                        op: str = "read") -> StreamToken:
        """Begin an async gather of (file_index, file_offset, dest_offset,
        length) chunks into *dest*. Pieces go out up to queue_depth at once;
        the rest follow as :meth:`poll` reaps completions. The token must be
        driven to :meth:`drain` (or given to :meth:`cancel`) before the
        engine serves another transfer. *fail_fast*=False lets the gather
        go on past a failed chunk, which retires as a negative
        ChunkCompletion. ``op="write"`` runs it in reverse: *dest* is the
        source and each chunk writes dest[dest_offset:+length) to
        file[file_offset:), the files registered ``writable=True``; a
        retry rewrites the whole piece, and a short write retries as a
        short read does."""
        if op not in ("read", "write"):
            raise ValueError(f"op must be 'read' or 'write', got {op!r}")
        tok = StreamToken(chunks, dest, self.config.block_size, retries,
                          fail_fast=fail_fast, op=op)
        self._track_token(tok)
        self._pump_token(tok)
        return tok

    def write_vectored(self, chunks: Sequence[tuple[int, int, int, int]],
                       src: np.ndarray, *, retries: int = 1) -> int:
        """The blocking write twin of :meth:`read_vectored`: (file_index,
        file_offset, src_offset, length) chunks out of *src*, block_size
        pieces pipelined at queue_depth with per-piece retries, through the
        async token. Returns bytes written; raises EngineError on a failed
        or short chunk. The same one-transfer-at-a-time contract."""
        return self.drain(self.submit_vectored(chunks, src, retries=retries,
                                               op="write"))

    def poll(self, token: StreamToken, min_completions: int = 1,
             timeout_s: float | None = None) -> list[ChunkCompletion]:
        """Reap engine completions, resubmit failed pieces within the retry
        budget, top the queue back up, and return the chunks that retired
        since the last call. Blocks until *min_completions* chunks retired
        (0: never blocks), the token is done, or *timeout_s* passed; a wait
        with no completion at all for ``engine_wait_timeout_s`` raises
        EngineStallError."""
        if token.cancelled:
            raise EngineError(_ECANCELED, "token cancelled (engine closing?)")
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        self._pump_token(token)
        while (len(token._ready) < max(min_completions, 1)
               and token._pending and not token.cancelled):
            if min_completions <= 0:
                wait_s = 0.0
            elif deadline is None:
                wait_s = self.wait_timeout_s
            else:
                wait_s = min(max(0.0, deadline - time.monotonic()),
                             self.wait_timeout_s)
            wait_t0 = time.monotonic()
            got = self._reap_token(token, wait_s)
            self._pump_token(token)
            if min_completions <= 0:
                break
            # a stall is a wait that went quiet for the whole watchdog; a
            # wait that returned early with another token's completions is
            # a busy engine, not a wedged one
            if not got and not token._ready and token._pending \
                    and wait_s >= self.wait_timeout_s \
                    and time.monotonic() - wait_t0 >= self.wait_timeout_s:
                raise EngineStallError(self.wait_timeout_s,
                                       list(token._pending), "poll")
            if not got and deadline is not None \
                    and time.monotonic() >= deadline:
                break
        out = token._ready
        token._ready = []
        if token.done:
            self._untrack_token(token)
        return out

    def drain(self, token: StreamToken) -> int:
        """Run the token to completion and return the bytes landed. Raises
        the first chunk error only after every in-flight piece has retired,
        so a caller reacting to it never races a write into its buffer."""
        while not token.done:
            self.poll(token, min_completions=1)
        self._untrack_token(token)
        if token.cancelled:
            raise EngineError(_ECANCELED, "token cancelled (engine closing?)")
        if token._err is not None:
            raise token._err
        return token.bytes_done

    def cancel(self, token: StreamToken,
               timeout_s: float | None = None) -> None:
        """Stop feeding the token and reap every piece already in flight:
        the worker or kernel owns a piece's dest bytes until it completes,
        so none may be left to land in memory the caller reuses. The token
        is marked cancelled first, so a concurrent poll/drain raises
        ECANCELED on its next call instead of competing for completions.
        *timeout_s* (default ``engine_wait_timeout_s``) bounds the reap."""
        if timeout_s is None:
            timeout_s = self.wait_timeout_s
        token.cancelled = True
        token._exhausted = True
        token._backlog.clear()
        deadline = time.monotonic() + timeout_s
        while token._pending and time.monotonic() < deadline:
            self._reap_token(token, 0.05)
        self._untrack_token(token)

    def _track_token(self, tok) -> None:
        self._live_tokens.append(tok)

    def _untrack_token(self, tok) -> None:
        if tok in self._live_tokens:
            self._live_tokens.remove(tok)

    def _cancel_live_tokens(self) -> None:
        """Engines call this first in close(): no completion may be left in
        flight against a dying ring or worker pool."""
        for tok in list(self._live_tokens):
            # best effort at close: a token that can no longer be cancelled
            # is past the point where its completions could land
            with contextlib.suppress(EngineError):
                self.cancel(tok)

    def _pump_token(self, tok: StreamToken) -> None:
        """Refill the queue from the backlog and the piece iterator up to
        queue_depth, in one submit_raw call. Pieces past a partial accept
        (the uring engine's ``.accepted``) go back onto the backlog."""
        if (tok._err is not None and tok.fail_fast) or tok.cancelled:
            return
        qd = self.config.queue_depth
        while len(tok._pending) < qd:
            batch: list[tuple[int, int, int, int, int, int]] = []
            while len(tok._pending) + len(batch) < qd:
                if tok._backlog:
                    batch.append(tok._backlog.pop())
                    continue
                if tok._exhausted:
                    break
                piece = next(tok._pieces, None)
                if piece is None:
                    tok._exhausted = True
                    break
                batch.append(piece)
            if not batch:
                break
            reqs = []
            make = RawWrite if tok.op == "write" else RawRead
            for piece in batch:
                ci, fi, fo, do, want, attempts = piece
                tag = self._vec_tag
                self._vec_tag += 1
                # registered before submission: a completion can land, and
                # a concurrent reap must find it, inside submit_raw
                tok._pending[tag] = piece
                reqs.append(make(fi, fo, want, tok._d8[do: do + want], tag))
            try:
                self.submit_raw(reqs)
            except EngineError as e:
                accepted = getattr(e, "accepted", 0)
                for r in reqs[accepted:]:
                    tok._pending.pop(r.tag, None)
                if e.errno != errno.EAGAIN:
                    # an op the engine can never take (bad index, closed
                    # engine): fail the token; in-flight pieces still drain
                    tok._err = e
                    tok._exhausted = True
                    tok._backlog.clear()
                    return
                tok._backlog.extend(batch[accepted:])
                break
            tok.inflight_peak = max(tok.inflight_peak, len(tok._pending))

    def _reap_token(self, tok: StreamToken, timeout_s: float | None) -> int:
        """One wait() round: retire pieces, queue failed ones for a retry
        within the budget, record chunk completions. Returns how many of
        this token's pieces completed."""
        try:
            comps = self.wait(min_completions=1, timeout_s=timeout_s)
        except EngineError as e:
            tok._err = tok._err or e
            tok._exhausted = True
            tok._backlog.clear()
            return 0
        n = 0
        for c in comps:
            piece = tok._pending.pop(c.tag, None)
            if piece is None:
                continue  # foreign tag: not ours to account
            n += 1
            ci, fi, fo, do, want, attempts = piece
            failed = c.result < want
            chunk_failed = tok._results[ci] is not None and not tok.fail_fast
            if failed and (tok._err is None or not tok.fail_fast) \
                    and not tok.cancelled and not chunk_failed \
                    and attempts < tok.retries:
                # a short read or write retries the whole piece: a
                # truncated transfer recovers, a true EOF fails once
                # retries are spent
                tok._backlog.append((ci, fi, fo, do, want, attempts + 1))
                continue
            if c.result < 0:
                err = EngineError(
                    -c.result, f"{tok.op} failed after {attempts + 1} "
                               f"attempts: {os.strerror(-c.result)}")
            elif c.result < want:
                tok.bytes_done += c.result
                err = EngineError(
                    _ENODATA, f"short {tok.op} ({c.result} < {want})"
                    + (" — file smaller than requested range?"
                       if tok.op == "read" else ""))
            else:
                tok.bytes_done += c.result
                err = None
            if err is not None:
                if tok._err is None:
                    tok._err = err
                if tok.fail_fast:
                    tok._exhausted = True   # stop feeding; drain the rest
                    tok._backlog.clear()
                if tok._results[ci] is None:
                    tok._results[ci] = -(err.errno or errno.EIO)
                    tok._ready.append(ChunkCompletion(ci, tok._results[ci]))
                continue
            tok._left[ci] -= want
            if tok._left[ci] == 0 and tok._results[ci] is None:
                ln = tok.chunks[ci][3]
                tok._results[ci] = ln
                tok._ready.append(ChunkCompletion(ci, ln))
        return n


def iter_chunks(offset: int, length: int, block: int) -> Iterable[tuple[int, int]]:
    """Split [offset, offset+length) into (offset, len) chunks of *block* bytes."""
    pos = offset
    end = offset + length
    while pos < end:
        take = min(block, end - pos)
        yield pos, take
        pos += take
