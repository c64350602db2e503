"""Multi-ring engine: N independent io_uring rings, gathers fanned out per
file (the port's copy of the synchronous half of ``strom/engine/multi.py``).

Each ring is a child :class:`UringEngine` with its own SQ/CQ, staging pool,
locks and counters. Routing:

- a gather touching ONE file runs whole on the next ring, round-robin, so
  concurrent independent transfers land on different rings;
- a gather spanning files (RAID0 members, multi-shard extent lists) is
  split per file (file i → ring i mod N, stable) and the per-ring
  sub-gathers run in parallel, all joined before any error is raised: the
  userspace twin of per-device blk-mq queues.

``concurrent_gathers = True`` tells the delivery layer to skip its
whole-transfer engine lock; serialization happens here, per ring.
"""

from __future__ import annotations

import concurrent.futures
import errno as _errno
import itertools
import threading
from typing import Sequence

import numpy as np

from strom_torch.config import StromConfig
from strom_torch.engine.base import (Completion, Engine, EngineError, RawRead,
                                     ReadRequest)
from strom_torch.engine.uring_engine import UringEngine


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
        # my file index -> (path, o_direct); child registrations are lazy (a
        # file occupies a ring's fd table only once a transfer lands there)
        self._files: dict[int, tuple[str, bool | None]] = {}
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
    def register_file(self, path: str, *, o_direct: bool | None = None) -> int:
        with self._reg_lock:
            fi = self._next_fi
            self._next_fi += 1
            self._files[fi] = (path, o_direct)
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
            path, od = ent
            ci = m[fi] = self._children[ring].register_file(path, o_direct=od)
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

    def submit(self, requests: Sequence[ReadRequest]) -> int:
        return self._children[0].submit([
            ReadRequest(self._child_index(0, r.file_index), r.offset, r.length,
                        r.buf_index, r.tag, r.buf_offset) for r in requests])

    def submit_raw(self, requests: Sequence[RawRead]) -> int:
        return self._children[0].submit_raw([
            RawRead(self._child_index(0, r.file_index), r.offset, r.length,
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
            ring = fi % n
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

    # -- observability and lifecycle ----------------------------------------
    def stats(self) -> dict:
        per_ring = [c.stats() for c in self._children]
        out: dict = {"engine": self.name, "rings": len(self._children)}
        for key in ("ops_submitted", "ops_completed", "ops_errored",
                    "ops_faulted", "bytes_read", "unaligned_fallback_reads",
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
        self._closed = True
        self._pool.shutdown(wait=True)
        for c in self._children:
            c.close()
