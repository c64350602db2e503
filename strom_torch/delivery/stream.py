"""Completion-driven gather (the port's copy of ``strom/delivery/stream.py``,
without peers, hedges and fallback recovery).

A blocking gather makes every sample of a batch wait for the slowest
extent. :class:`StreamingGather` plans the gather as
``StromContext._read_segments`` does (``_plan_chunks``: striped aliases,
coalescing, stripe windows), submits it through the engine's async API
(``submit_vectored`` / ``poll``) and reports dest byte ranges the moment
their chunks land, so the vision pipeline can decode a sample while later
extents are still in flight. With the hot cache on, the gather consults
it after planning: cached ranges are copied into *dest* at construction and
surface as INSTANT completions on the first ``poll`` (counted as
``stream_instant_bytes``); only the misses reach the engine, and each
landed chunk is offered for admission.

Rules:

- Completions are unordered across chunks, and every dest byte completes
  exactly once: ranges from distinct completions never overlap.
- The gather owns the engine's transfer path from construction until its
  token drains: a scheduler grant for its miss bytes, billed to its tenant
  (the context's engine lock with ``sched_enabled=False``; per-ring locks
  on the multi-ring engine) is held that long, then released at once, and
  on every error path.
- ``finish`` raises ``EngineError`` only after every in-flight piece has
  retired, and checks that the engine moved exactly the planned bytes.
- ``close`` is idempotent and safe mid-flight: the token is cancelled
  (every in-flight piece reaped) before the grant is released, so no
  engine write lands in *dest* after it returns.
"""

from __future__ import annotations

import contextlib
import errno
import time
from typing import Sequence

import numpy as np

from strom_torch.delivery.shard import Segment
from strom_torch.engine.base import EngineError, EngineStallError


class StreamingGather:
    """One completion-driven gather of *segments* from *source* into *dest*.

    Protocol::

        g = ctx.stream_segments(source, segments, dest)
        try:
            while not g.done:
                for lo, hi in g.poll():   # dest byte ranges, landed
                    ...work on dest[lo:hi]...
            g.finish()                    # integrity check
        finally:
            g.close()                     # idempotent; cancels if unfinished
    """

    def __init__(self, ctx, source, segments: Sequence[Segment],
                 dest: np.ndarray, base_offset: int = 0, *,
                 tenant: str | None = None):
        self._ctx = ctx
        self._tenant = tenant
        self._dflat = dest if dest.ndim == 1 and dest.dtype == np.uint8 \
            else dest.reshape(-1).view(np.uint8)
        self._closed = False
        self._finished = False
        self._token = None
        self._failed: set[int] = set()   # chunk indices that failed
        self._stack = contextlib.ExitStack()
        self._engine_released = False
        # gather-level watchdog: piece progress (bytes_done) resets it
        self._stall_t0 = time.monotonic()
        self._stall_bytes = -1
        self._instant: list[tuple[int, int]] = []
        try:
            chunks, self._idx_paths = ctx._plan(source, segments, base_offset)
            planned = sum(ln for (_, _, _, ln) in chunks)
            if planned > self._dflat.nbytes:
                raise ValueError(f"dest holds {self._dflat.nbytes} bytes, the "
                                 f"gather plans {planned}")
            self._cache = ctx._active_cache()
            hit_bytes = 0
            if self._cache is not None and chunks:
                chunks, hit_bytes, self._instant = ctx._consult_cache(
                    self._cache, chunks, self._idx_paths, self._dflat,
                    tenant=tenant)
            self._chunks = chunks
            self._miss_planned = planned - hit_bytes
            self.total_bytes = planned
            self.instant_bytes = hit_bytes
            if self._chunks:
                # both held for the token's lifetime; released by
                # _release_engine the moment the last piece retires
                self._stack.enter_context(ctx._demand_gate())
                if ctx.scheduler is not None:
                    self._stack.enter_context(ctx.scheduler.grant(
                        tenant, self._miss_planned))
                else:
                    self._stack.enter_context(ctx._engine_lock)
                self._token = ctx.engine.submit_vectored(
                    self._chunks, self._dflat, retries=ctx.config.io_retries,
                    fail_fast=False)
            ctx._count(stream_gathers=1, stream_instant_bytes=hit_bytes)
        except BaseException:
            self._stack.close()
            self._closed = True
            raise

    @property
    def done(self) -> bool:
        """Every cache-served range reported and every piece retired (or
        the gather was cancelled). ``finish`` must still be called."""
        if self._instant:
            return False
        return self._token is None or self._token.done

    @property
    def inflight_peak(self) -> int:
        """The deepest the engine's queue ran for this gather."""
        return self._token.inflight_peak if self._token is not None else 0

    def poll(self, min_completions: int = 1,
             timeout_s: float | None = None) -> list[tuple[int, int]]:
        """Dest ranges landed since the last call. The first call returns
        the cache-served ranges at once; later calls reap the engine.
        ``min_completions=0`` never blocks. A failed chunk yields no range;
        ``finish`` raises for it."""
        if self._closed:
            return []
        if self._instant:
            out, self._instant = self._instant, []
            self._stall_t0 = time.monotonic()
            return out
        tok = self._token
        if tok is None:
            return []
        out: list[tuple[int, int]] = []
        if not tok.done:
            for c in self._ctx.engine.poll(tok, min_completions, timeout_s):
                fi, fo, do, ln = self._chunks[c.index]
                if c.result < 0:
                    self._failed.add(c.index)
                    continue
                out.append((do, do + ln))
                if self._cache is not None:
                    # the bytes just landed in dest: admitting is one
                    # memcpy (the admission policy decides)
                    path = self._idx_paths.get(fi)
                    if path is not None:
                        self._cache.admit(path, fo, fo + ln,
                                          self._dflat[do: do + ln],
                                          tenant=self._tenant)
        if out:
            self._stall_t0 = time.monotonic()
        elif min_completions > 0 and not tok.done:
            # callers poll in short slices, so the engine's own watchdog
            # never fires from here: this one turns a silent hang into an
            # error. One long chunk moving at full speed retires no chunk
            # for a while, so piece progress counts as progress.
            if tok.bytes_done != self._stall_bytes:
                self._stall_bytes = tok.bytes_done
                self._stall_t0 = time.monotonic()
            elif time.monotonic() - self._stall_t0 \
                    >= self._ctx.config.engine_wait_timeout_s:
                raise EngineStallError(self._ctx.config.engine_wait_timeout_s,
                                       list(tok._pending), "stream.poll")
        if tok.done:
            # drained: hand the engine back now, not at finish()
            self._release_engine()
        return out

    def finish(self) -> int:
        """Run the gather to its end and verify it. Returns the bytes
        gathered. Raises the first chunk error after every piece retired."""
        if self._finished:
            return self.total_bytes
        tok = self._token
        try:
            while tok is not None and not tok.done:
                self.poll(min_completions=1, timeout_s=1.0)
        except EngineError as e:
            # cancel before the caller can react: the engine owns the
            # in-flight pieces' dest bytes until each retires
            if tok is not None and not tok.done:
                self._ctx.engine.cancel(tok)
            self._release()
            if isinstance(e, EngineStallError):
                raise
            raise EngineError(e.errno, f"ssd2gpu {e.strerror}") from None
        self._release()
        if self._failed:
            err = tok.error
            code = err.errno if err is not None else errno.EIO
            why = err.strerror if err is not None \
                else f"{len(self._failed)} chunk(s) failed"
            raise EngineError(code or errno.EIO, f"ssd2gpu {why}")
        if tok is not None and tok.bytes_done != self._miss_planned:
            # any engine accounting bug surfaces here, not as a batch with
            # a zero tail
            raise EngineError(errno.EIO,
                              f"ssd2gpu streamed read {tok.bytes_done} "
                              f"bytes, planned {self._miss_planned}")
        self._ctx._count(ssd2gpu_bytes=self.total_bytes)
        return self.total_bytes

    def _release_engine(self) -> None:
        """Drop the grant (or engine lock) and the demand gate;
        idempotent."""
        if not self._engine_released:
            self._engine_released = True
            self._stack.close()

    def _release(self) -> None:
        self._finished = True
        self._closed = True
        self._release_engine()

    def close(self) -> None:
        """Idempotent teardown. A live token is cancelled, every in-flight
        piece reaped, before the grant is released."""
        if self._finished:
            return
        if self._token is not None and not self._token.done:
            self._ctx.engine.cancel(self._token)
        self._release()

    def __enter__(self) -> "StreamingGather":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
