"""Multi-ring engine: N independent io_uring rings, gathers fanned out per
file (the port's copy of ``strom/engine/multi.py``, without ring quarantine
and recovery).

Each ring is a child :class:`UringEngine` with its own SQ/CQ, staging pool,
locks and counters. Routing:

- a gather touching ONE file runs whole on the next ring, round-robin, so
  concurrent independent transfers land on different rings;
- a gather spanning files (RAID0 members, multi-shard extent lists) is
  split per file (file i → ring i mod N, stable) and the per-ring
  sub-gathers run in parallel, all joined before any error is raised: the
  userspace twin of per-device blk-mq queues.

``concurrent_gathers = True`` tells the delivery layer to skip its
whole-transfer engine lock; serialization happens here, per ring. An async
gather (:meth:`MultiRingEngine.submit_vectored`) is routed the same way:
one child token per ring, its ring's lock held until the fan token drains
or is cancelled.
"""

from __future__ import annotations

import concurrent.futures
import errno as _errno
import itertools
import threading
import time
from typing import Sequence

import numpy as np

from strom_torch.config import StromConfig
from strom_torch.engine.base import (ChunkCompletion, Completion, Engine,
                                     EngineError, EngineStallError, RawRead,
                                     RawWrite, ReadRequest, StreamToken)
from strom_torch.engine.uring_engine import UringEngine


class _FanToken:
    """A multi-ring async gather: one child StreamToken per ring, chunk
    indices mapped back to the caller's list. Reads like a StreamToken to
    the delivery layer (done, cancelled, bytes_done, inflight_peak, error,
    _pending, pending_chunk_indices)."""

    __slots__ = ("chunks", "parts", "locks", "cancelled", "last_progress_t",
                 "last_bytes_done")

    def __init__(self, chunks, parts, locks):
        self.chunks = list(chunks)
        # [(ring, child_engine, child_token, [parent chunk index]), ...]
        self.parts = parts
        self.locks = locks  # the rings' locks, released exactly once
        self.cancelled = False
        # the fan's own stall clock: child polls run in short slices, so
        # the children's watchdog never fires; piece progress resets it
        self.last_progress_t = time.monotonic()
        self.last_bytes_done = -1

    @property
    def done(self) -> bool:
        return self.cancelled or all(p[2].done for p in self.parts)

    @property
    def bytes_done(self) -> int:
        return sum(p[2].bytes_done for p in self.parts)

    @property
    def inflight_peak(self) -> int:
        # the rings' queues fill independently: their depths add up
        return sum(p[2].inflight_peak for p in self.parts)

    @property
    def error(self) -> EngineError | None:
        return next((p[2].error for p in self.parts
                     if p[2].error is not None), None)

    @property
    def _pending(self) -> dict:
        # keyed (ring, tag): each child numbers its tags from 0
        return {(ring, tag): piece for ring, _, ctok, _ in self.parts
                for tag, piece in ctok._pending.items()}

    def pending_chunk_indices(self) -> set:
        return {imap[ci] for _, _, ctok, imap in self.parts
                for ci in ctok.pending_chunk_indices()}

    def _release_locks(self) -> None:
        locks, self.locks = self.locks, []
        for lk in locks:
            lk.release()


class MultiRingEngine(Engine):
    name = "multi"
    concurrent_gathers = True  # delivery must not wrap gathers in its own lock

    def __init__(self, config: StromConfig):
        super().__init__(config)
        n = config.engine_rings
        self._children: list[UringEngine] = []
        try:
            for _ in range(n):
                self._children.append(UringEngine(config))
        except BaseException:
            # a later ring failing (RLIMIT_MEMLOCK, fd caps) must not leak
            # the earlier rings' pinned pools and fds
            for c in self._children:
                c.close()
            raise
        # my file index -> (path, o_direct, writable); child registrations
        # are lazy (a file occupies a ring's fd table only once a transfer
        # lands there), each with the writability asked for
        self._files: dict[int, tuple[str, bool | None, bool]] = {}
        self._next_fi = 0
        self._child_fi: list[dict[int, int]] = [dict() for _ in range(n)]
        self._reg_lock = threading.Lock()
        # per-ring transfer locks: a child's read_vectored reaps its whole
        # CQ, so two gathers on one ring must not overlap
        self._ring_locks = [threading.Lock() for _ in range(n)]
        self._rr = itertools.count()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="strom-ring")
        self._closed = False

    # -- files --------------------------------------------------------------
    def register_file(self, path: str, *, o_direct: bool | None = None,
                      writable: bool = False) -> int:
        with self._reg_lock:
            fi = self._next_fi
            self._next_fi += 1
            self._files[fi] = (path, o_direct, writable)
        # eager on ring 0, so the O_DIRECT probe runs once up front and
        # file_uses_o_direct answers without I/O later
        self._child_index(0, fi)
        return fi

    def _child_index(self, ring: int, fi: int) -> int:
        """The child engine's file index for my index *fi*, registering it
        lazily. The whole get-or-register runs under one lock: concurrent
        gathers must not double-register a file on a ring (leaking the
        loser's fd pair) or race unregister_file."""
        with self._reg_lock:
            m = self._child_fi[ring]
            ci = m.get(fi)
            if ci is not None:
                return ci
            ent = self._files.get(fi)
            if ent is None:
                raise EngineError(_errno.EBADF, f"file index {fi} not registered")
            path, od, wr = ent
            ci = m[fi] = self._children[ring].register_file(
                path, o_direct=od, writable=wr)
            return ci

    def unregister_file(self, file_index: int) -> None:
        with self._reg_lock:
            self._files.pop(file_index, None)
            regs = [(r, m.pop(file_index)) for r, m in enumerate(self._child_fi)
                    if file_index in m]
        for r, ci in regs:
            self._children[r].unregister_file(ci)

    def file_uses_o_direct(self, file_index: int) -> bool:
        return self._children[0].file_uses_o_direct(self._child_index(0, file_index))

    # -- staging pool / per-op paths: ring 0 owns them ----------------------
    # Not safe to run concurrently with gathers: a gather that lands on ring
    # 0 reaps its CQ and drops completions it does not own. Use the per-op
    # API only while no gather is in flight.
    def buffer(self, buf_index: int) -> np.ndarray:
        return self._children[0].buffer(buf_index)

    def buffer_info(self) -> dict:
        """Every ring owns a full staging pool: the total is the pinned
        footprint of all of them, with one ring's beside it."""
        info = self._children[0].buffer_info()
        info.update(engine=self.name, rings=len(self._children),
                    per_ring_bytes=info["total_bytes"],
                    total_bytes=info["total_bytes"] * len(self._children))
        return info

    def set_scope(self, scope) -> None:
        """Every ring gets the scope: the rings own the submit and wait
        edges the per-op accounting runs on."""
        self._op_scope = scope
        for c in self._children:
            c.set_scope(scope)

    def submit(self, requests: Sequence[ReadRequest]) -> int:
        return self._children[0].submit([
            ReadRequest(self._child_index(0, r.file_index), r.offset, r.length,
                        r.buf_index, r.tag, r.buf_offset) for r in requests])

    def submit_raw(self, requests: Sequence[RawRead | RawWrite]) -> int:
        return self._children[0].submit_raw([
            type(r)(self._child_index(0, r.file_index), r.offset, r.length,
                    r.dest, r.tag) for r in requests])

    def wait(self, min_completions: int = 1,
             timeout_s: float | None = None) -> list[Completion]:
        return self._children[0].wait(min_completions, timeout_s)

    def in_flight(self) -> int:
        return sum(c.in_flight() for c in self._children)

    # -- registered dests: every ring gets the slab -------------------------
    def register_dest(self, arr: np.ndarray) -> int:
        done = []
        for c in self._children:
            if c.register_dest(arr) < 0:
                # all-or-nothing: -1 means the caller will not unregister, so
                # a partial success would leak pinned registrations
                for d in done:
                    d.unregister_dest(arr)
                return -1
            done.append(c)
        return 0

    def unregister_dest(self, arr: np.ndarray) -> None:
        for c in self._children:
            c.unregister_dest(arr)

    def unregister_dest_addr(self, addr: int) -> None:
        for c in self._children:
            c.unregister_dest_addr(addr)

    # -- the vectored hot path: route, fan out, join ------------------------
    def _route(self, fi: int) -> int:
        """A file's home ring: stable, so its fds and READ_FIXED
        registrations stay where its gathers land."""
        return fi % len(self._children)

    def read_vectored(self, chunks: Sequence[tuple[int, int, int, int]],
                      dest: np.ndarray, *, retries: int = 1) -> int:
        if self._closed:
            raise EngineError(_errno.EBADF, "engine closed")
        n = len(self._children)
        if n == 1 or len({c[0] for c in chunks}) == 1:
            ring = next(self._rr) % n
            ch = [(self._child_index(ring, fi), fo, do, ln)
                  for (fi, fo, do, ln) in chunks]
            with self._ring_locks[ring]:
                return self._children[ring].read_vectored(ch, dest,
                                                          retries=retries)
        per_ring: list[list[tuple[int, int, int, int]]] = [[] for _ in range(n)]
        for (fi, fo, do, ln) in chunks:
            ring = self._route(fi)
            per_ring[ring].append((self._child_index(ring, fi), fo, do, ln))

        def run(ring: int) -> int:
            with self._ring_locks[ring]:
                return self._children[ring].read_vectored(
                    per_ring[ring], dest, retries=retries)

        live = [r for r in range(n) if per_ring[r]]
        futs = [self._pool.submit(run, r) for r in live]
        # join every ring before raising: a caller reacting to an error must
        # not race sub-gathers still writing into dest
        concurrent.futures.wait(futs)
        err = next((f.exception() for f in futs if f.exception() is not None),
                   None)
        if err is not None:
            raise err
        return sum(f.result() for f in futs)

    # -- async vectored gather: fan tokens across the rings ------------------
    def submit_vectored(self, chunks: Sequence[tuple[int, int, int, int]],
                        dest: np.ndarray, *, retries: int = 1,
                        fail_fast: bool = True,
                        op: str = "read") -> _FanToken:
        """The async twin of read_vectored's routing: one child token per
        ring, completions mapped back to the caller's chunk indices
        (``op="write"``: the same fan-out of a write scatter). The
        live rings' locks are held for the token's lifetime (a blocking
        gather on the same ring would reap, and drop as foreign, the
        token's completions) and released at drain or cancel."""
        if self._closed:
            raise EngineError(_errno.EBADF, "engine closed")
        n = len(self._children)
        per_ring: dict[int, tuple[list, list]] = {}  # ring -> (chunks, imap)
        if chunks and (n == 1 or len({c[0] for c in chunks}) == 1):
            ring = next(self._rr) % n
            per_ring[ring] = ([(self._child_index(ring, fi), fo, do, ln)
                               for (fi, fo, do, ln) in chunks],
                              list(range(len(chunks))))
        else:
            for i, (fi, fo, do, ln) in enumerate(chunks):
                ring = self._route(fi)
                ch, imap = per_ring.setdefault(ring, ([], []))
                ch.append((self._child_index(ring, fi), fo, do, ln))
                imap.append(i)
        live = sorted(per_ring)  # lock in ring order: no ABBA with a peer
        locks: list[threading.Lock] = []
        parts = []
        try:
            for r in live:
                # held until the token drains or is cancelled
                self._ring_locks[r].acquire()
                locks.append(self._ring_locks[r])
            for r in live:
                ch, imap = per_ring[r]
                parts.append((r, self._children[r],
                              self._children[r].submit_vectored(
                                  ch, dest, retries=retries,
                                  fail_fast=fail_fast, op=op), imap))
        except BaseException:
            for _, child, ctok, _ in parts:
                child.cancel(ctok)
            for lk in locks:
                lk.release()
            raise
        tok = _FanToken(chunks, parts, locks)
        self._track_token(tok)
        if tok.done:  # empty gather
            tok._release_locks()
            self._untrack_token(tok)
        return tok

    def poll(self, token, min_completions: int = 1,
             timeout_s: float | None = None) -> list[ChunkCompletion]:
        if isinstance(token, StreamToken):  # a child token handed back
            return super().poll(token, min_completions, timeout_s)
        if token.cancelled:
            raise EngineError(_errno.ECANCELED,
                              "token cancelled (engine closing?)")
        out: list[ChunkCompletion] = []

        def land(imap, cs) -> None:
            for c in cs:
                token.last_progress_t = time.monotonic()
                out.append(ChunkCompletion(imap[c.index], c.result))

        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        block_rr = 0
        while True:
            for _, child, ctok, imap in token.parts:
                if not ctok.done:
                    land(imap, child.poll(ctok, min_completions=0))
            if len(out) >= min_completions or min_completions <= 0 \
                    or token.done:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            # block briefly on one unfinished ring, in turn, so a quiet
            # ring cannot starve completions waiting on another
            live = [p for p in token.parts if not p[2].done]
            _, child, ctok, imap = live[block_rr % len(live)]
            block_rr += 1
            wait_s = 0.005
            if deadline is not None:
                wait_s = min(wait_s, max(0.0, deadline - time.monotonic()))
            land(imap, child.poll(ctok, min_completions=1, timeout_s=wait_s))
            now_bytes = token.bytes_done
            if now_bytes != token.last_bytes_done:
                token.last_bytes_done = now_bytes
                token.last_progress_t = time.monotonic()
            elif time.monotonic() - token.last_progress_t \
                    >= self.wait_timeout_s and token._pending:
                raise EngineStallError(self.wait_timeout_s,
                                       list(token._pending), "multi.poll")
        if token.done:
            token._release_locks()
            self._untrack_token(token)
        return out

    def drain(self, token) -> int:
        if isinstance(token, StreamToken):
            return super().drain(token)
        while not token.done:
            self.poll(token, min_completions=1)
        token._release_locks()
        self._untrack_token(token)
        if token.cancelled:
            raise EngineError(_errno.ECANCELED,
                              "token cancelled (engine closing?)")
        if token.error is not None:
            raise token.error
        return token.bytes_done

    def cancel(self, token, timeout_s: float | None = None) -> None:
        """One deadline shared by the child tokens, so cancelling a wedged
        N-ring gather costs about *timeout_s*, not N times it; each child
        still gets a floored slice, so every one is marked cancelled and
        reaped once."""
        if timeout_s is None:
            timeout_s = self.wait_timeout_s
        if isinstance(token, StreamToken):
            return super().cancel(token, timeout_s)
        deadline = time.monotonic() + timeout_s
        for _, child, ctok, _ in token.parts:
            child.cancel(ctok, max(deadline - time.monotonic(), 0.05))
        token.cancelled = True
        token._release_locks()
        self._untrack_token(token)

    # -- observability and lifecycle ----------------------------------------
    def stats(self) -> dict:
        per_ring = [c.stats() for c in self._children]
        out: dict = {"engine": self.name, "rings": len(self._children)}
        for key in ("ops_submitted", "ops_completed", "ops_errored",
                    "ops_faulted", "bytes_read", "ops_written",
                    "bytes_written", "unaligned_fallback_reads",
                    "eof_topup_reads", "chunk_retries", "ops_fixed",
                    "cached_bytes", "media_bytes", "residency_probes",
                    "in_flight", "enter_submit_calls", "sqpoll_wakeups",
                    "dest_refused"):
            out[key] = sum(int(s.get(key, 0)) for s in per_ring)
        # coverage from the summed counters (a mean of per-ring ratios would
        # weight an idle ring like a busy one)
        out["engine_fixed_buf_ratio"] = (
            out["ops_fixed"] / out["ops_submitted"]
            if out["ops_submitted"] else 0.0)
        out["engine_unregistered_reads"] = max(
            0, out["ops_submitted"] - out["ops_fixed"])
        # feature flags: the children share one config, ring 0 speaks for all
        for key in ("fixed_buffers", "fixed_files", "mlocked", "coop_taskrun",
                    "sqpoll", "sparse_table"):
            out[key] = per_ring[0].get(key)
        hist = [sum(s["read_latency_hist"][i] for s in per_ring)
                for i in range(len(per_ring[0]["read_latency_hist"]))]
        total = sum(int(s["read_latency_count"]) for s in per_ring)
        sum_us = sum(float(s["read_latency_total_us"]) for s in per_ring)
        out["read_latency_hist"] = hist
        out["read_latency_count"] = total
        out["read_latency_total_us"] = sum_us
        out["read_latency_mean_us"] = sum_us / total if total else 0.0
        for q, name in ((0.5, "read_latency_p50_us"),
                        (0.99, "read_latency_p99_us")):
            acc, val = 0, 0.0
            for i, b in enumerate(hist):
                acc += b
                if total and acc >= q * total:
                    val = float(1 << (i + 1))
                    break
            out[name] = val
        out["ring_stats"] = per_ring
        return out

    def close(self) -> None:
        if self._closed:
            return
        # fan tokens first, while the rings live: their ring locks release
        # and every child piece is reaped before a ring is torn down
        self._cancel_live_tokens()
        self._closed = True
        self._pool.shutdown(wait=True)
        for c in self._children:
            c.close()
