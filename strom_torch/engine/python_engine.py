"""Pure-Python engine: a preadv worker pool over an O_DIRECT / buffered fd
pair per file (the port's copy of ``strom/engine/python_engine.py``).

An aligned op (offset, length and destination address all on the file's
DIO alignment) reads through the O_DIRECT fd, straight from the device into
the caller's slab; an unaligned op, and the unaligned tail O_DIRECT returns
short at EOF, read through the buffered fd.

The residency hybrid (``residency_hybrid``, on by default): an aligned op
whose pages are all in the page cache reads through the buffered fd
instead, a memcpy from the cache, and counts as ``cached_bytes``; the rest
count as ``media_bytes``. A gather's residency is snapshotted before any of
its reads runs (``_snapshot_residency``), since a warm read's readahead
would otherwise warm the ranges ahead of it; a stand-alone op probes
itself. Neither probe populates the cache.

A write (:class:`RawWrite`, to a file registered ``writable=True``) takes
the O_DIRECT fd when it is aligned and the buffered fd otherwise
(``unaligned_fallback_writes``); the residency hybrid is a read-side
economy and writes skip it.
"""

from __future__ import annotations

import errno as _errno
import mmap
import os
import queue
import threading
import time
from typing import Sequence

import numpy as np

from strom_torch.config import StromConfig
from strom_torch.engine.base import (Completion, Engine, EngineError, RawRead,
                                     RawWrite, ReadRequest)
from strom_torch.obs.events import ring as _events_ring
from strom_torch.probe.odirect import probe_dio
from strom_torch.probe.residency import cached_pages, range_fully_cached
from strom_torch.utils.locks import make_lock


class _File:
    __slots__ = ("fd", "fd_buffered", "o_direct", "mem_align", "offset_align",
                 "path")

    def __init__(self, path: str, fd: int, fd_buffered: int, o_direct: bool,
                 mem_align: int, offset_align: int):
        self.path = path
        self.fd = fd
        self.fd_buffered = fd_buffered
        self.o_direct = o_direct
        self.mem_align = mem_align
        self.offset_align = offset_align


class PythonEngine(Engine):
    """Thread-pool preadv engine. Default 4 I/O threads (they block in the
    kernel, so >1 helps even on a single core)."""

    name = "python"

    def __init__(self, config: StromConfig, *, n_workers: int = 4):
        super().__init__(config)
        self._pool = mmap.mmap(-1, config.num_buffers * config.buffer_size)
        self._np_pool = np.frombuffer(self._pool, dtype=np.uint8)
        self._files: dict[int, _File] = {}
        self._next_file = 0
        self._submit_q: queue.SimpleQueue = queue.SimpleQueue()
        self._done_q: queue.SimpleQueue[Completion] = queue.SimpleQueue()
        self._in_flight = 0
        self._lock = make_lock("engine.python")
        self._stats = {"ops_submitted": 0, "ops_completed": 0,
                       "ops_errored": 0, "bytes_read": 0, "media_bytes": 0,
                       "cached_bytes": 0, "residency_probes": 0,
                       "unaligned_fallback_reads": 0, "o_direct_denied": 0,
                       "ops_faulted": 0, "ops_written": 0,
                       "bytes_written": 0, "direct_writes": 0,
                       "buffered_writes": 0, "unaligned_fallback_writes": 0}
        self._fault_counter = 0
        self._closed = False
        # the gather in flight's residency snapshot, {(file_index, offset):
        # warm} per block_size piece (read_vectored); None between gathers
        self._warm_map: dict[tuple[int, int], bool] | None = None
        self._workers = [
            threading.Thread(target=self._worker, name=f"strom-io-{i}",
                             daemon=True)
            for i in range(n_workers)
        ]
        for w in self._workers:
            w.start()

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    # -- files --------------------------------------------------------------
    def register_file(self, path: str, *, o_direct: bool | None = None,
                      writable: bool = False) -> int:
        want_direct = self.config.o_direct if o_direct is None else o_direct
        dio = probe_dio(path)
        use_direct = dio.supported if want_direct is None \
            else (want_direct and dio.supported)
        if want_direct is True and not dio.supported:
            self._count("o_direct_denied")  # observable degrade, not an error
        # writable: both fds read-write, so aligned writes ride O_DIRECT and
        # unaligned ones the buffered fd, as reads do
        flags = os.O_RDWR if writable else os.O_RDONLY
        fd_buffered = os.open(path, flags)
        if use_direct:
            try:
                fd = os.open(path, flags | os.O_DIRECT)
            except OSError:
                fd = os.dup(fd_buffered)
                use_direct = False
                self._count("o_direct_denied")
        else:
            fd = os.dup(fd_buffered)
        with self._lock:
            idx = self._next_file
            self._next_file += 1
            self._files[idx] = _File(path, fd, fd_buffered, use_direct,
                                     dio.mem_align or 4096,
                                     dio.offset_align or 4096)
        return idx

    def unregister_file(self, file_index: int) -> None:
        with self._lock:
            f = self._files.pop(file_index, None)
        if f is not None:
            os.close(f.fd)
            os.close(f.fd_buffered)

    def file_uses_o_direct(self, file_index: int) -> bool:
        return self._files[file_index].o_direct

    # -- pool ---------------------------------------------------------------
    def buffer(self, buf_index: int) -> np.ndarray:
        if not 0 <= buf_index < self.config.num_buffers:
            raise IndexError(buf_index)
        start = buf_index * self.config.buffer_size
        return self._np_pool[start: start + self.config.buffer_size]

    # -- submit/wait --------------------------------------------------------
    def _admit(self, n: int) -> None:
        if self._closed:
            raise EngineError(_errno.EBADF, "engine closed")
        with self._lock:
            if self._in_flight + n > self.config.queue_depth:
                raise EngineError(
                    _errno.EAGAIN,
                    f"queue depth exceeded ({self._in_flight}+{n} > "
                    f"{self.config.queue_depth})")
            self._in_flight += n
            self._stats["ops_submitted"] += n

    def submit(self, requests: Sequence[ReadRequest]) -> int:
        for r in requests:  # validate everything before committing any state
            if r.buf_offset + r.length > self.config.buffer_size:
                raise EngineError(_errno.EINVAL, "read larger than buffer slot")
        self._admit(len(requests))
        self._note_submitted(requests)
        for r in requests:
            self._submit_q.put(r)
        return len(requests)

    def submit_raw(self, requests: Sequence[RawRead]) -> int:
        self._admit(len(requests))
        self._note_submitted(requests)
        for r in requests:
            self._submit_q.put(r)
        return len(requests)

    def wait(self, min_completions: int = 1,
             timeout_s: float | None = None) -> list[Completion]:
        out: list[Completion] = []
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while len(out) < min_completions:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                out.append(self._done_q.get(timeout=remaining))
            except queue.Empty:
                break
        while True:  # drain anything else already complete
            try:
                out.append(self._done_q.get_nowait())
            except queue.Empty:
                break
        if out:
            with self._lock:
                self._in_flight -= len(out)
            self._note_completed(out)
        return out

    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def stats(self) -> dict:
        with self._lock:
            snap = dict(self._stats)
            snap["in_flight"] = self._in_flight
        snap["engine"] = self.name
        return snap

    def close(self) -> None:
        if self._closed:
            return
        self._cancel_live_tokens()
        self._closed = True
        for _ in self._workers:
            self._submit_q.put(None)  # workers drain queued reads first
        for w in self._workers:
            w.join(timeout=5)
        if not any(w.is_alive() for w in self._workers):
            self._forget_abandoned()   # no worker can write any more
        for idx in list(self._files):
            self.unregister_file(idx)

    # -- vectored gather: residency snapshotted first -----------------------
    # residency probes per mixed (part warm, part cold) chunk: its pieces
    # are probed in groups of ceil(n / 256), a group warm only when fully
    # resident, so coarse probing can send warm bytes to media, never cold
    # bytes to the cache
    MAX_RESIDENCY_PROBES = 256

    def _snapshot_residency(self, chunks) -> dict[tuple[int, int], bool] | None:
        """{(file_index, piece_offset): warm} for every block_size piece the
        gather will submit, probed before any read runs. One probe decides a
        file-contiguous run of chunks that is wholly warm or wholly cold;
        only a mixed run is probed chunk by chunk."""
        if not self.config.residency_hybrid:
            return None
        block = self.config.block_size
        m: dict[tuple[int, int], bool] = {}
        elig = []
        for fi, fo, _do, ln in chunks:
            f = self._files.get(fi)
            if f is not None and f.o_direct and ln > 0:
                elig.append((fi, fo, ln, f))
        elig.sort(key=lambda t: (t[0], t[1]))
        runs: list[list] = []   # [fi, start, end, file, [(offset, length)]]
        for fi, fo, ln, f in elig:
            if runs and runs[-1][0] == fi and runs[-1][2] == fo:
                runs[-1][2] = fo + ln
                runs[-1][4].append((fo, ln))
            else:
                runs.append([fi, fo, fo + ln, f, [(fo, ln)]])

        def mark(fi: int, fo: int, ln: int, warm: bool) -> None:
            for p in range(0, ln, block):
                m[(fi, fo + p)] = warm

        def probe_chunk(fi: int, fo: int, ln: int, f) -> None:
            self._count("residency_probes")
            r = cached_pages(f.fd_buffered, fo, ln)
            if r is None:
                return   # unprobeable: the worker probes the piece itself
            res, tot = r
            if res >= tot or res == 0:
                # cold pieces get an explicit False: an absent key would
                # have the worker probe after readahead may have warmed it
                mark(fi, fo, ln, res >= tot)
                return
            npieces = (ln + block - 1) // block
            group = -(-npieces // self.MAX_RESIDENCY_PROBES)
            for g0 in range(0, npieces, group):
                self._count("residency_probes")
                warm = range_fully_cached(
                    f.fd_buffered, fo + g0 * block,
                    min(group * block, ln - g0 * block)) is True
                for ci in range(g0, min(g0 + group, npieces)):
                    m[(fi, fo + ci * block)] = warm

        for fi, start, end, f, members in runs:
            if len(members) == 1:
                probe_chunk(fi, start, end - start, f)
                continue
            self._count("residency_probes")
            r = cached_pages(f.fd_buffered, start, end - start)
            if r is None:
                continue
            res, tot = r
            if res >= tot or res == 0:
                for fo, ln in members:
                    mark(fi, fo, ln, res >= tot)
                continue
            for fo, ln in members:   # a mixed run: chunk by chunk
                probe_chunk(fi, fo, ln, f)
        return m

    def read_vectored(self, chunks, dest, *, retries: int = 1) -> int:
        with _events_ring.span("engine.python.read_vectored", cat="read",
                               args={"ops": len(chunks),
                                     "bytes": sum(c[3] for c in chunks)}):
            self._warm_map = self._snapshot_residency(chunks)
            try:
                return super().read_vectored(chunks, dest, retries=retries)
            finally:
                self._warm_map = None

    # -- worker -------------------------------------------------------------
    def _take_fault(self) -> bool:
        """fault_every=N: every Nth op completes with EIO unread."""
        n = self.config.fault_every
        if n <= 0:
            return False
        with self._lock:
            self._fault_counter += 1
            return self._fault_counter % n == 0

    def _worker(self) -> None:
        while True:
            req = self._submit_q.get()
            if req is None:
                return
            if self._take_fault():
                self._count("ops_faulted")
                self._done_q.put(Completion(req.tag, -_errno.EIO))
                continue
            f = self._files.get(req.file_index)
            if f is None:
                self._done_q.put(Completion(req.tag, -_errno.EBADF))
                continue
            if isinstance(req, (RawRead, RawWrite)):
                view = memoryview(req.dest.view(np.uint8).reshape(-1))[: req.length]
                addr = req.dest.__array_interface__["data"][0]
            else:
                start = req.buf_index * self.config.buffer_size + req.buf_offset
                view = memoryview(self._pool)[start: start + req.length]
                addr = start  # the pool base is page-aligned
            aligned = (req.offset % f.offset_align == 0
                       and req.length % f.offset_align == 0
                       and addr % f.mem_align == 0)
            if isinstance(req, RawWrite):
                self._write(req, f, view, f.o_direct and aligned)
                continue
            # residency hybrid: a warm piece is a memcpy from the page cache
            # through the buffered fd, not a media read
            warm = False
            if f.o_direct and aligned and self.config.residency_hybrid:
                wm = self._warm_map
                warm = None if wm is None else wm.get((req.file_index,
                                                       req.offset))
                if warm is None:
                    self._count("residency_probes")
                    warm = range_fully_cached(f.fd_buffered, req.offset,
                                              req.length) is True
            direct = f.o_direct and aligned and not warm
            if f.o_direct and not aligned:
                self._count("unaligned_fallback_reads")
            try:
                n = os.preadv(f.fd if direct else f.fd_buffered, [view],
                              req.offset)
                if direct and n < req.length:
                    # O_DIRECT may return short at an aligned EOF: top up
                    # the unaligned tail through the buffered fd
                    n += os.preadv(f.fd_buffered, [view[n:]], req.offset + n)
                with self._lock:
                    self._stats["bytes_read"] += n
                    self._stats["ops_completed"] += 1
                    if f.o_direct and aligned:
                        self._stats["cached_bytes" if warm else
                                    "media_bytes"] += n
                self._done_q.put(Completion(req.tag, n))
            except OSError as e:
                self._count("ops_errored")
                self._done_q.put(Completion(req.tag, -(e.errno or _errno.EIO)))

    def _write(self, req: RawWrite, f: _File, view: memoryview,
               direct: bool) -> None:
        """One write op: the O_DIRECT fd when aligned, else the buffered
        fd. A short write counts no bytes: the retry rewrites the whole
        piece, and its full completion counts once."""
        try:
            n = os.pwritev(f.fd if direct else f.fd_buffered, [view],
                           req.offset)
            with self._lock:
                self._stats["ops_completed"] += 1
                self._stats["direct_writes" if direct else
                            "buffered_writes"] += 1
                if f.o_direct and not direct:
                    self._stats["unaligned_fallback_writes"] += 1
                if n >= req.length:
                    self._stats["ops_written"] += 1
                    self._stats["bytes_written"] += n
            self._done_q.put(Completion(req.tag, n))
        except OSError as e:
            self._count("ops_errored")
            self._done_q.put(Completion(req.tag, -(e.errno or _errno.EIO)))
