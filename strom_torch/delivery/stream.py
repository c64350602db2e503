"""Completion-driven gather (the port's copy of ``strom/delivery/stream.py``).

A blocking gather makes every sample of a batch wait for the slowest
extent. :class:`StreamingGather` plans the gather as
``StromContext._read_segments`` does (``_plan_chunks``: striped aliases,
coalescing, stripe windows), submits it through the engine's async API
(``submit_vectored`` / ``poll``) and reports dest byte ranges the moment
their chunks land, so the vision pipeline can decode a sample while later
extents are still in flight. With the hot cache on, the gather consults
it after planning: cached ranges are copied into *dest* at construction and
surface as INSTANT completions on the first ``poll`` (counted as
``stream_instant_bytes``); so do the ranges a peer served (a context
with :meth:`StromContext.attach_peers` asks its peers even without a hot
cache). Only the misses reach the engine, and each landed chunk is
offered for admission (a ``cache.admit`` span at release).

Rules:

- Completions are unordered across chunks, and every dest byte completes
  exactly once: ranges from distinct completions never overlap.
- The gather owns the engine's transfer path from construction until its
  token drains: a scheduler grant for its miss bytes, billed to its tenant
  (the context's engine lock with ``sched_enabled=False``; per-ring locks
  on the multi-ring engine) is held that long, then released at once, and
  on every error path.
- The gather is (or joins) a traced request, and a request it mints
  carries ``request_deadline_s``: past it, the open chunks retire with
  DeadlineExceeded, which ``finish`` raises after cancelling the rest.
- The token runs ``fail_fast=False``: a chunk that failed after its
  retries is read again, inline, by the context's fallback engine
  (``ResilientIo.read_chunk_fallback``, counted in ``failover_reads``), so
  one bad extent does not fail the batch. A token that died at submission
  (engine death) gets one fallback pass over its unserved chunks. The
  circuit breaker hears one outcome per gather.
- Hedged reads: a gather quiet past ``ResilientIo.hedge``'s threshold
  re-reads its chunks with primary pieces in flight on the fallback
  engine, each chunk at most once (``hedges_fired``). The first completion
  wins (``hedges_won``); a losing primary completion is dropped, its bytes
  counted in ``hedge_wasted_bytes``, and the loser's pieces still in flight
  are cancelled (reaped) before the grant goes.
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

from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.shard import Segment
from strom_torch.engine.base import (DeadlineExceeded, EngineError,
                                     EngineStallError)
from strom_torch.obs import request as _request
from strom_torch.obs.events import ring as _events_ring


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
        self._stack = contextlib.ExitStack()
        self._engine_released = False
        self.t0_us = _events_ring.now_us()
        self._first_c_us: "float | None" = None
        self._last_c_us: "float | None" = None
        # gather-level watchdog: piece progress (bytes_done) resets it
        self._stall_t0 = time.monotonic()
        self._stall_bytes = -1
        self._last_prog_t = time.monotonic()   # the hedges' quiet clock
        self._instant: list[tuple[int, int]] = []
        self._admitted = 0                  # bytes admitted as chunks land
        self._resil = ctx.resilience
        self._completed: set[int] = set()   # engine-served chunk indices
        self._recovered: set[int] = set()   # fallback-served after failure
        self._hedged: set[int] = set()      # fallback-served by a hedge
        self._hedge_tried: set[int] = set()  # one hedge a chunk, ever
        self._failed: dict[int, int] = {}   # unrecovered: ci -> errno
        self._recovery_attempted = False
        self._breaker_fed = False           # one breaker outcome a gather
        # join the enclosing request (a streamed batch's) or mint one; a
        # minted request carries the config's deadline and finishes at
        # release
        req = _request.current()
        self._own_req = req is None
        self.req = req if req is not None \
            else _request.Request("gather", tenant)
        if self._own_req:
            self.req.set_deadline_s(ctx.config.request_deadline_s or None)
        try:
            with _request.attach(self.req):
                chunks, self._idx_paths = ctx._plan(source, segments,
                                                    base_offset)
                planned = sum(ln for (_, _, _, ln) in chunks)
                if planned > self._dflat.nbytes:
                    raise ValueError(f"dest holds {self._dflat.nbytes} "
                                     f"bytes, the gather plans {planned}")
                self._cache = ctx._active_cache()
                hit_bytes = 0
                if (self._cache is not None
                        or ctx.peer_tier is not None) and chunks:
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
                        self._chunks, self._dflat,
                        retries=ctx.config.io_retries, fail_fast=False,
                        deadline=self.req.deadline)
                ctx._count(stream_gathers=1, stream_instant_bytes=hit_bytes)
        except BaseException as e:
            self._stack.close()
            self._closed = True
            if self._own_req:
                self.req.mark_error(e)
                self.req.finish()
            raise

    @property
    def done(self) -> bool:
        """Every cache-served range reported and every chunk served, by
        the engine or the fallback (or the gather was cancelled).
        ``finish`` must still be called."""
        if self._instant:
            return False
        tok = self._token
        if tok is None:
            return True
        if tok.done:
            # a token that died at submission leaves chunks unserved: one
            # fallback pass still owes their ranges
            return self._recovery_attempted or tok.error is None \
                or not self._n_unaccounted()
        # a live token: done once every chunk is served, or once the
        # deadline closed the open ones (finish cancels the pieces still
        # in flight and raises DeadlineExceeded)
        if self._n_unaccounted():
            return False
        return not self._failed or isinstance(tok.error, DeadlineExceeded)

    @property
    def inflight_peak(self) -> int:
        """The deepest the engine's queue ran for this gather."""
        return self._token.inflight_peak if self._token is not None else 0

    def _n_unaccounted(self) -> int:
        """How many chunks no one has served or failed yet, in O(1) (the
        pump checks ``done`` every poll): each chunk lands in exactly one
        of the four disjoint sets."""
        return len(self._chunks) - len(self._completed) \
            - len(self._recovered) - len(self._hedged) - len(self._failed)

    def _unaccounted(self) -> list[int]:
        served = self._completed | self._recovered | self._hedged
        return [ci for ci in range(len(self._chunks))
                if ci not in served and ci not in self._failed]

    def _mark_progress(self) -> None:
        now = _events_ring.now_us()
        if self._first_c_us is None:
            self._first_c_us = now
        self._last_c_us = now
        self._last_prog_t = time.monotonic()
        self._stall_t0 = self._last_prog_t

    def _chunk_fallback(self, ci: int) -> bool:
        """Read chunk *ci* on the fallback engine straight into dest; True
        on success. Recovered bytes are not offered to the cache: the
        primary just failed around them."""
        fi, fo, do, ln = self._chunks[ci]
        path = self._idx_paths.get(fi)
        if path is None:
            return False
        ok = self._resil.read_chunk_fallback(path, fo, ln,
                                             self._dflat[do: do + ln])
        if ok:
            self._resil.scope.add("failover_reads")
            self._resil.scope.add("failover_bytes", ln)
        return ok

    def _feed_breaker(self, *, ok: bool) -> None:
        """One breaker outcome a gather, not a chunk: a batch of 10^4
        chunks with a few recovered must not read as a 100 % error rate.
        The first outcome wins: failures are fed at recovery, the success
        at finish."""
        if self._resil.breaker is None or self._breaker_fed:
            return
        self._breaker_fed = True
        if ok:
            self._resil.breaker.record_success()
        else:
            self._resil.breaker.record_failure()

    def poll(self, min_completions: int = 1,
             timeout_s: float | None = None) -> list[tuple[int, int]]:
        """Dest ranges landed since the last call. The first call returns
        the cache-served ranges at once; later calls reap the engine, a
        failed chunk recovered on the fallback inline. ``min_completions=0``
        never blocks. An unrecovered chunk yields no range; ``finish``
        raises for it."""
        if self._closed:
            return []
        if self._instant:
            out, self._instant = self._instant, []
            self._mark_progress()
            return out
        tok = self._token
        if tok is None:
            return []
        out: list[tuple[int, int]] = []
        if not tok.done:
            hedge = self._resil.hedge
            wait_s = timeout_s
            if min_completions > 0 and hedge is not None:
                # wake at the hedge threshold: a quiet gather gets its
                # hedge decision even when the caller asked for a long wait
                quiet = time.monotonic() - self._last_prog_t
                to_hedge = max(hedge.threshold_s() - quiet, 0.005)
                wait_s = to_hedge if wait_s is None else min(wait_s,
                                                             to_hedge)
            for c in self._ctx.engine.poll(tok, min_completions, wait_s):
                fi, fo, do, ln = self._chunks[c.index]
                if c.index in self._hedged or c.index in self._recovered:
                    # the fallback already served (and emitted) this
                    # chunk: this late primary completion lost the race.
                    # Its range must not reach the consumer twice, and its
                    # bytes are not offered to the cache
                    if c.index in self._hedged and c.result >= 0:
                        # both sides moved the bytes: the loser's are waste
                        self._resil.scope.add("hedge_wasted_bytes", ln)
                    continue
                if c.result < 0:
                    # a deadline miss is the request's contract, not
                    # evidence about the engine: no lifeboat, no breaker
                    missed = isinstance(tok.error, DeadlineExceeded)
                    if not missed and self._chunk_fallback(c.index):
                        self._recovered.add(c.index)
                        self._mark_progress()
                        out.append((do, do + ln))
                    else:
                        self._failed[c.index] = -c.result
                    if not missed:
                        self._feed_breaker(ok=False)
                    continue
                self._completed.add(c.index)
                if hedge is not None:
                    hedge.observe(time.monotonic() - self._last_prog_t)
                self._mark_progress()
                out.append((do, do + ln))
                if self._cache is not None:
                    # the bytes just landed in dest: admitting is one
                    # memcpy (the admission policy decides)
                    path = self._idx_paths.get(fi)
                    if path is not None:
                        self._admitted += self._cache.admit(
                            path, fo, fo + ln, self._dflat[do: do + ln],
                            tenant=self._tenant)
            if not out and min_completions > 0 and hedge is not None \
                    and not tok.done \
                    and time.monotonic() - self._last_prog_t \
                    >= hedge.threshold_s():
                out.extend(self._fire_hedges())
        if tok.done and tok.error is not None \
                and not self._recovery_attempted:
            # the token died at submission (engine death mid-gather): one
            # fallback pass over the chunks that never completed
            out.extend(self._recover_unaccounted())
        if not out and min_completions > 0 and not tok.done:
            # callers poll in short slices, so the engine's own watchdog
            # never fires from here: this one turns a silent hang into an
            # error. One long chunk moving at full speed retires no chunk
            # for a while, so piece progress counts as progress.
            if tok.bytes_done != self._stall_bytes:
                self._stall_bytes = tok.bytes_done
                self._stall_t0 = time.monotonic()
            elif time.monotonic() - self._stall_t0 \
                    >= self._ctx.config.engine_wait_timeout_s:
                self._ctx.engine._note_stall()
                raise EngineStallError(self._ctx.config.engine_wait_timeout_s,
                                       list(tok._pending), "stream.poll")
        if tok.done:
            # drained: hand the engine back now, not at finish()
            self._release_engine()
        elif self.done:
            # every chunk served but the token still owns in-flight loser
            # pieces (hedges won over a wedged primary): cancel first, so
            # the next tenant's gather never reaps their completions while
            # their dest writes are still the engine's
            with contextlib.suppress(Exception):
                self._ctx.engine.cancel(tok)
            self._release_engine()
        return out

    def _fire_hedges(self) -> list[tuple[int, int]]:
        """Hedge the quiet gather's stragglers on the fallback engine: each
        chunk with primary pieces in flight is re-read into a scratch
        buffer, and the copy wins (``hedges_won``: poll reaps on this same
        thread, so a chunk still unaccounted here has no delivered
        primary). The losing pieces are cancelled before the grant goes; a
        loser completing before that is dropped in poll, its bytes counted
        in ``hedge_wasted_bytes``. Each chunk is hedged at most once a
        gather: a straggler whose fallback read fails too must not refire
        every poll. The winner's paste can overlap a loser's write still
        landing only where both read the same file range: the same bytes.
        Runs under the grant the gather's thread already holds."""
        scope = self._resil.scope
        out: list[tuple[int, int]] = []
        # only chunks with primary pieces in flight: a quiet gap must not
        # re-read the not-yet-submitted tail the primary will still read
        live = self._token.pending_chunk_indices()
        for ci in self._unaccounted():
            if ci not in live or ci in self._hedge_tried:
                continue
            fi, fo, do, ln = self._chunks[ci]
            path = self._idx_paths.get(fi)
            if path is None:
                continue
            self._hedge_tried.add(ci)
            scope.add("hedges_fired")
            scratch = alloc_aligned(ln)
            if not self._resil.read_chunk_fallback(path, fo, ln, scratch):
                continue
            self._dflat[do: do + ln] = scratch
            self._hedged.add(ci)
            scope.add("hedges_won")
            self._mark_progress()
            out.append((do, do + ln))
        # even a pass that won nothing resets the quiet clock: the next
        # decision waits a whole threshold
        self._last_prog_t = time.monotonic()
        return out

    def _recover_unaccounted(self) -> list[tuple[int, int]]:
        self._recovery_attempted = True
        out: list[tuple[int, int]] = []
        err = self._token.error
        if isinstance(err, DeadlineExceeded):
            for ci in self._unaccounted():
                self._failed[ci] = errno.ETIMEDOUT
            return out
        for ci in self._unaccounted():
            fi, fo, do, ln = self._chunks[ci]
            if self._chunk_fallback(ci):
                self._recovered.add(ci)
                self._mark_progress()
                out.append((do, do + ln))
            else:
                self._failed[ci] = err.errno or errno.EIO
            self._feed_breaker(ok=False)
        return out

    def finish(self) -> int:
        """Run the gather to its end and verify it. Returns the bytes
        gathered, cache hits included. Raises the first unrecovered chunk
        error after every piece retired; past the deadline, the rest is
        cancelled first and DeadlineExceeded raised."""
        if self._finished:
            return self.total_bytes
        tok = self._token
        try:
            while tok is not None and not self.done:
                if isinstance(tok.error, DeadlineExceeded):
                    break   # fail fast: the cancel below reaps in-flight
                self.poll(min_completions=1, timeout_s=1.0)
        except EngineError as e:
            # cancel before the caller can react: the engine owns the
            # in-flight pieces' dest bytes until each retires
            if tok is not None and not tok.done:
                self._ctx.engine.cancel(tok)
            self.req.mark_error(e)
            self._release()
            if isinstance(e, (DeadlineExceeded, EngineStallError)):
                raise
            raise EngineError(e.errno, f"ssd2gpu {e.strerror}") from None
        if tok is not None and not tok.done:
            # hedge losers and deadline leftovers: the first completion
            # won; the primary's pieces still in flight are reaped before
            # the grant goes
            self._ctx.engine.cancel(tok)
        self._release_engine()
        missed = tok is not None and isinstance(tok.error, DeadlineExceeded) \
            and (self._failed or self._unaccounted())
        if self._failed or missed:
            err = tok.error if tok.error is not None \
                else EngineError(errno.EIO,
                                 f"{len(self._failed)} chunk(s) failed")
            self.req.mark_error(err)
            self._release()
            if isinstance(err, (DeadlineExceeded, EngineStallError)):
                raise err
            raise EngineError(err.errno or errno.EIO,
                              f"ssd2gpu {err.strerror}")
        if tok is not None:
            if self._recovered or self._hedged:
                missing = self._unaccounted()
                if missing:
                    err = EngineError(errno.EIO,
                                      f"ssd2gpu streamed gather left "
                                      f"{len(missing)} chunk(s) unserved")
                    self.req.mark_error(err)
                    self._release()
                    raise err
            elif tok.bytes_done != self._miss_planned:
                # any engine accounting bug surfaces here, not as a batch
                # with a zero tail (exact only when the engine served
                # every chunk; recovered chunks are accounted one by one)
                err = EngineError(errno.EIO,
                                  f"ssd2gpu streamed read {tok.bytes_done} "
                                  f"bytes, planned {self._miss_planned}")
                self.req.mark_error(err)
                self._release()
                raise err
            # recoveries already fed their failure: the first outcome wins
            self._feed_breaker(ok=True)
        self._release()
        self._ctx._count(ssd2gpu_bytes=self.total_bytes)
        return self.total_bytes

    def _release_engine(self) -> None:
        """Drop the grant (or engine lock) and the demand gate;
        idempotent."""
        if not self._engine_released:
            self._engine_released = True
            self._stack.close()

    def _release(self) -> None:
        if self._finished:
            return
        self._finished = True
        self._closed = True
        if self._token is not None:
            self._ctx.scope.gauge("stream_inflight_peak").max(
                self._token.inflight_peak)
            # the async token never passes through the gather's read span:
            # the engine window is billed here, so the stall attribution's
            # read bucket sees streamed batches
            end = self._last_c_us if self._last_c_us is not None \
                else _events_ring.now_us()
            self.req.record("stream.read", "read", self.t0_us,
                            max(end - self.t0_us, 0.0),
                            {"ops": len(self._chunks),
                             "bytes": self._miss_planned})
        if self._first_c_us is not None and self._last_c_us is not None:
            # how long the slowest extent lagged the first completion: the
            # wait a whole-batch barrier would put on every sample
            self._ctx.scope.observe_us("stream_tail_extent",
                                       self._last_c_us - self._first_c_us)
        if self._admitted:
            self.req.record("cache.admit", "cache", self.t0_us,
                            _events_ring.now_us() - self.t0_us,
                            {"bytes": self._admitted})
        self._release_engine()
        if self._own_req:
            self.req.finish()

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
