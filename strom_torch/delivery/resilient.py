"""Engine failover (the port's copy of ``strom/delivery/resilient.py``).

:class:`ResilientIo` is owned by a :class:`StromContext` and sits between
the delivery read paths and the engine:

- a per-engine :class:`~strom_torch.engine.resilience.CircuitBreaker`
  records every demand gather's outcome. While it is closed, reads ride
  the primary engine as before; the gather that trips it, and every gather
  while it is open, reroutes to a fallback preadv pool built at first use:
  its own fds over the same paths and its own worker pool, sharing no
  state with the primary (on the H100's host, where ``io_uring_setup``
  gives ENOSYS, the primary is a preadv pool too). Half-open probes ride
  real traffic.
- the streamed path uses :meth:`ResilientIo.read_chunk_fallback` to
  recover a failed chunk inline, so one bad extent does not fail the batch,
  and to hedge a quiet gather's in-flight chunks past the threshold of
  :attr:`ResilientIo.hedge` (a ``HedgeController``; the first completion
  wins).

The fallback engine is serialized under its own lock (one fallback gather
at a time: it is a lifeboat, not a second fleet). Chunks are remapped by
path, so failover covers exactly the reads the delivery layer planned;
engine-level callers with untracked file indexes stay on the primary.
"""

from __future__ import annotations

import errno
from typing import Callable, Sequence

import numpy as np

from strom_torch.engine.base import DeadlineExceeded, EngineError
from strom_torch.engine.resilience import (CircuitBreaker, HedgeController,
                                           classify_errno)
from strom_torch.utils.locks import make_lock


class ResilientIo:
    def __init__(self, config, engine, *, scope=None):
        from strom_torch.utils.stats import global_stats

        self.config = config
        self.engine = engine
        self.scope = scope if scope is not None else global_stats
        self.breaker: "CircuitBreaker | None" = None
        if config.breaker_enabled:
            self.breaker = CircuitBreaker(
                window_s=config.breaker_window_s,
                min_events=config.breaker_min_events,
                error_rate=config.breaker_error_rate,
                cooldown_s=config.breaker_cooldown_s,
                half_open_successes=config.breaker_half_open_successes,
                scope=self.scope,
                name=getattr(engine, "name", "engine"))
        self.hedge: "HedgeController | None" = None
        # a zero floor and a zero multiplier are the off spelling: a
        # zero-threshold controller would hedge every chunk on every poll
        if config.hedge_enabled \
                and (config.hedge_min_s > 0 or config.hedge_multiplier > 0):
            self.hedge = HedgeController(min_s=config.hedge_min_s,
                                         multiplier=config.hedge_multiplier)
        self._fb = None
        self._fb_failed = False
        self._fb_lock = make_lock("resil.fallback")    # creation + fi map
        self._fb_serial = make_lock("resil.fallback_serial")
        self._fb_fi: dict[str, int] = {}

    # -- fallback engine -----------------------------------------------------
    def fallback_engine(self):
        """The preadv fallback engine, built on first use (None when it
        cannot be built: failover then degrades to plain propagation)."""
        with self._fb_lock:
            if self._fb is not None or self._fb_failed:
                return self._fb
            try:
                from strom_torch.engine.python_engine import PythonEngine

                self._fb = PythonEngine(self.config)
                self._fb.set_scope(self.scope)
            except (OSError, ValueError):
                self._fb_failed = True
            return self._fb

    def _fb_index(self, path: str) -> int:
        fb = self.fallback_engine()
        with self._fb_lock:
            fi = self._fb_fi.get(path)
            if fi is None:
                fi = fb.register_file(path, o_direct=self.config.o_direct)
                self._fb_fi[path] = fi
            return fi

    def can_fallback(self, chunks: Sequence[tuple[int, int, int, int]],
                     idx_paths: dict[int, str]) -> bool:
        """Failover needs a path per chunk (the fallback opens its own
        fds). Builds nothing: this runs on every healthy demand gather, and
        the lifeboat (a second buffer pool and its workers) must cost
        nothing until a read fails over."""
        if not chunks or any(fi not in idx_paths for (fi, _, _, _) in chunks):
            return False
        return not self._fb_failed

    def fallback_read(self, chunks: Sequence[tuple[int, int, int, int]],
                      dest: np.ndarray, idx_paths: dict[int, str]) -> int:
        """Run a planned gather on the fallback engine, the chunks remapped
        by path. Counts ``failover_reads`` and ``failover_bytes``."""
        fb = self.fallback_engine()
        if fb is None:
            raise EngineError(errno.EIO,
                              "failover requested but no fallback engine")
        remapped = [(self._fb_index(idx_paths[fi]), fo, do, ln)
                    for (fi, fo, do, ln) in chunks]
        with self._fb_serial:
            n = fb.read_vectored(remapped, dest,
                                 retries=self.config.io_retries)
        self.scope.add("failover_reads")
        self.scope.add("failover_bytes", n)
        return n

    def read_chunk_fallback(self, path: str, file_off: int, length: int,
                            out: np.ndarray) -> bool:
        """One chunk on the fallback path (the streamed gather's recovery):
        file[file_off : file_off+length) into *out*. True on a full read;
        False degrades quietly (the caller keeps its error)."""
        fb = self.fallback_engine()
        if fb is None:
            return False
        try:
            fi = self._fb_index(path)
            with self._fb_serial:
                n = fb.read_vectored([(fi, file_off, 0, length)], out,
                                     retries=self.config.io_retries)
            return n == length
        except (EngineError, OSError):
            return False

    # -- the demand-path wrapper --------------------------------------------
    def execute(self, primary: Callable[[], int],
                chunks: Sequence[tuple[int, int, int, int]],
                dest: np.ndarray, idx_paths: dict[int, str],
                arbitrate: "Callable[[Callable], int] | None" = None) -> int:
        """Run a planned demand gather under the breaker:

        - closed (or a half-open probe): run *primary* (the scheduler's
          sliced gather, or the engine under its lock). Success and
          failure feed the breaker. A transient failure that leaves the
          breaker open (this gather tripped it, or a probe failed)
          reroutes this gather to the fallback; otherwise the error
          propagates.
        - open: straight to the fallback, the primary untouched; a gather
          that cannot fail over (untracked file indexes) runs the primary.
        - DeadlineExceeded always propagates: a slower lifeboat does not
          honour the deadline.

        *arbitrate* (the context's scheduler wrapper) runs every fallback
        read: it takes a read-one-slice callable and drives it under the
        tenant's grants, so failover reads are budgeted, queued and
        preemptible at slice boundaries like the primary's."""
        br = self.breaker
        can_fb = self.can_fallback(chunks, idx_paths)

        def fallback() -> int:
            def read_slice(sl):
                return self.fallback_read(sl, dest, idx_paths)

            if arbitrate is not None:
                return arbitrate(read_slice)
            return read_slice(chunks)

        # allow() runs whether or not this gather can fail over: it owns
        # the open -> half-open transition, and without a fallback the
        # primary doubles as the probe
        if br is not None and not br.allow() and can_fb:
            return fallback()
        try:
            n = primary()
        except DeadlineExceeded:
            raise
        except EngineError as e:
            if br is None:
                raise
            if classify_errno(e.errno or errno.EIO) == "permanent":
                # a caller's bug (EINVAL, EBADF, ...) fails the same on any
                # engine: no evidence about this engine's health
                raise
            br.record_failure()
            if br.state != CircuitBreaker.OPEN or not can_fb:
                raise
            return fallback()
        if br is not None:
            br.record_success()
        return n

    # -- observability / lifecycle ------------------------------------------
    def stats(self) -> dict:
        out = {}
        if self.breaker is not None:
            out.update(self.breaker.info())
        out["failover_available"] = self._fb is not None
        if self.hedge is not None:
            out["hedge_threshold_us"] = round(
                self.hedge.threshold_s() * 1e6, 1)
        return out

    def close(self) -> None:
        with self._fb_lock:
            fb, self._fb = self._fb, None
            self._fb_failed = True
        if fb is not None:
            fb.close()
