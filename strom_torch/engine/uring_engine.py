"""ctypes binding to the C++ io_uring engine (the port's copy of
``strom/engine/uring_engine.py``; the library is ``strom_torch/_core``'s).

ctypes foreign calls release the GIL, so a gather runs in C++ while Python
threads go on; bulk bytes never pass through Python. A whole gather list is
one call (``sc_read_vectored``): batched SQE fills, one ``io_uring_enter``
per batch, per-chunk retry and the aligned-EOF top-up in C++. Caller slabs
registered with :meth:`UringEngine.register_dest` ride
``IORING_OP_READ_FIXED``.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import os
import threading
from typing import Sequence

import numpy as np

from strom_torch.config import StromConfig
from strom_torch.engine.base import (Completion, Engine, EngineError, RawRead,
                                     RawWrite, ReadRequest)

_HIST_BUCKETS = 24


class _ScCompletion(ctypes.Structure):
    _fields_ = [("tag", ctypes.c_uint64), ("res", ctypes.c_int64)]


class _ScStats(ctypes.Structure):
    _fields_ = [
        ("ops_submitted", ctypes.c_uint64),
        ("ops_completed", ctypes.c_uint64),
        ("ops_errored", ctypes.c_uint64),
        ("ops_faulted", ctypes.c_uint64),
        ("bytes_read", ctypes.c_uint64),
        ("unaligned_fallback_reads", ctypes.c_uint64),
        ("eof_topup_reads", ctypes.c_uint64),
        ("lat_count", ctypes.c_uint64),
        ("lat_total_us", ctypes.c_uint64),
        ("lat_hist", ctypes.c_uint64 * _HIST_BUCKETS),
        ("in_flight", ctypes.c_uint32),
        ("fixed_buffers", ctypes.c_uint8),
        ("fixed_files", ctypes.c_uint8),
        ("mlocked", ctypes.c_uint8),
        ("chunk_retries", ctypes.c_uint64),
        ("coop_taskrun", ctypes.c_uint8),
        ("sparse_table", ctypes.c_uint8),
        ("ext_buffers", ctypes.c_uint32),
        ("ops_fixed", ctypes.c_uint64),
        ("sqpoll", ctypes.c_uint8),
        ("sqpoll_wakeup_errno", ctypes.c_uint32),
        ("cached_bytes", ctypes.c_uint64),
        ("media_bytes", ctypes.c_uint64),
        ("residency_probes", ctypes.c_uint64),
        ("ops_written", ctypes.c_uint64),
        ("bytes_written", ctypes.c_uint64),
        ("enter_submit_calls", ctypes.c_uint64),
        ("sqpoll_wakeups", ctypes.c_uint64),
    ]


class _ScVecSeg(ctypes.Structure):
    _fields_ = [
        ("file_index", ctypes.c_int32),
        ("length", ctypes.c_uint32),
        ("offset", ctypes.c_uint64),
        ("dest_offset", ctypes.c_uint64),
    ]


class _ScRawOp(ctypes.Structure):
    _fields_ = [
        ("file_index", ctypes.c_int32),
        ("length", ctypes.c_uint32),
        ("offset", ctypes.c_uint64),
        ("tag", ctypes.c_uint64),
        ("addr", ctypes.c_void_p),
        ("buf_index", ctypes.c_int32),  # registered table index; -1 = plain READ
        ("op_flags", ctypes.c_int32),   # bit0: force the buffered fd (hybrid)
    ]


# sc_vec_seg.length / sc_raw_op.length are uint32; ctypes would silently mask
# larger Python ints (5 GiB -> 1 GiB), turning an oversized chunk into a
# zero-tailed array with no error. Chunks are split to this limit before they
# reach ctypes, and anything that still doesn't fit raises.
_MAX_SEG = 1 << 31
_SC_OP_WRITE = 2   # sc_raw_op.op_flags bit 1: IORING_OP_WRITE from addr


def _split_chunks(chunks, limit: int = _MAX_SEG):
    """Split (file_index, file_offset, dest_offset, length) chunks so every
    length fits the C ABI's uint32 fields."""
    out = []
    for fi, fo, do, ln in chunks:
        if ln < 0:
            raise ValueError(f"negative chunk length {ln}")
        while ln > limit:
            out.append((fi, fo, do, limit))
            fo += limit
            do += limit
            ln -= limit
        out.append((fi, fo, do, ln))
    return out


_lib = None
_lib_lock = threading.Lock()
# why the last uring_available() said False: the errno of the failed
# sc_create (0 when a ring was made, or when the library did not build)
create_errno = 0
unavailable_reason = ""


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from strom_torch._core.build import ensure_built

        lib = ctypes.CDLL(ensure_built(), use_errno=True)
        lib.sc_create.restype = ctypes.c_void_p
        lib.sc_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                  ctypes.c_uint64, ctypes.c_uint32]
        lib.sc_destroy.restype = None
        lib.sc_destroy.argtypes = [ctypes.c_void_p]
        lib.sc_pool_base.restype = ctypes.c_void_p
        lib.sc_pool_base.argtypes = [ctypes.c_void_p]
        lib.sc_register_file.restype = ctypes.c_int
        lib.sc_register_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int]
        lib.sc_unregister_file.restype = ctypes.c_int
        lib.sc_unregister_file.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.sc_file_is_o_direct.restype = ctypes.c_int
        lib.sc_file_is_o_direct.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.sc_submit_read.restype = ctypes.c_int
        lib.sc_submit_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_uint64, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_uint32,
                                       ctypes.c_uint64]
        lib.sc_wait.restype = ctypes.c_int
        lib.sc_wait.argtypes = [ctypes.c_void_p, ctypes.POINTER(_ScCompletion),
                                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
        lib.sc_in_flight.restype = ctypes.c_uint32
        lib.sc_in_flight.argtypes = [ctypes.c_void_p]
        lib.sc_get_stats.restype = None
        lib.sc_get_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(_ScStats)]
        lib.sc_set_fault_every.restype = None
        lib.sc_set_fault_every.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.sc_submit_raw_batch.restype = ctypes.c_int
        lib.sc_submit_raw_batch.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(_ScRawOp),
                                            ctypes.c_uint32,
                                            ctypes.POINTER(ctypes.c_int32)]
        lib.sc_read_vectored.restype = ctypes.c_int64
        lib.sc_read_vectored.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(_ScVecSeg),
                                         ctypes.c_uint64, ctypes.c_void_p,
                                         ctypes.c_uint32, ctypes.c_uint32,
                                         ctypes.c_int32]
        lib.sc_register_dest.restype = ctypes.c_int
        lib.sc_register_dest.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_uint64]
        lib.sc_unregister_dest.restype = ctypes.c_int
        lib.sc_unregister_dest.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return lib


def uring_available() -> bool:
    """True if the library builds and the kernel accepts io_uring_setup.
    On False, ``create_errno`` and ``unavailable_reason`` say why."""
    global create_errno, unavailable_reason
    try:
        lib = _load_lib()
    except (RuntimeError, OSError) as e:
        create_errno, unavailable_reason = 0, f"build: {e}"
        return False
    h = lib.sc_create(2, 1, 4096, 0)
    if not h:
        err = ctypes.get_errno() or _errno.ENOSYS
        create_errno = err
        unavailable_reason = (f"sc_create: {_errno.errorcode.get(err, err)} "
                              f"({os.strerror(err)})")
        return False
    lib.sc_destroy(ctypes.c_void_p(h))
    create_errno, unavailable_reason = 0, ""
    return True


class UringEngine(Engine):
    name = "uring"

    def __init__(self, config: StromConfig):
        super().__init__(config)
        self._lib = _load_lib()
        # flag bits of sc_create: mlock, register buffers, register files,
        # COOP_TASKRUN, SQPOLL, residency hybrid
        flags = (1 if config.mlock else 0) | (2 if config.register_buffers else 0) \
            | 4 | (8 if config.coop_taskrun else 0) \
            | (16 if config.sqpoll else 0) \
            | (32 if config.residency_hybrid else 0)
        handle = self._lib.sc_create(config.queue_depth, config.num_buffers,
                                     config.buffer_size, flags)
        if not handle:
            err = ctypes.get_errno() or _errno.ENOSYS
            raise EngineError(err, f"io_uring engine init failed: "
                                   f"{os.strerror(err)}")
        self._h = ctypes.c_void_p(handle)
        pool_base = self._lib.sc_pool_base(self._h)
        pool_bytes = config.num_buffers * config.buffer_size
        # zero-copy view over the engine-owned mmap'd pool
        self._np_pool = np.ctypeslib.as_array(
            ctypes.cast(pool_base, ctypes.POINTER(ctypes.c_uint8)),
            shape=(pool_bytes,))
        if config.fault_every:
            self._lib.sc_set_fault_every(self._h, config.fault_every)
        self._closed = False
        self._comp_buf = (_ScCompletion * max(config.queue_depth, 64))()
        self._raw_keepalive: dict[int, np.ndarray] = {}
        # caller slabs registered for READ_FIXED gathers: base addr -> (table
        # index, length). _dest_lock serializes registration changes against
        # close(): a slab may be released from any thread while another
        # tears the ring down.
        self._dest_regs: dict[int, tuple[int, int]] = {}
        self._dest_refused = 0
        self._dest_lock = threading.Lock()

    # -- files --------------------------------------------------------------
    def register_file(self, path: str, *, o_direct: bool | None = None,
                      writable: bool = False) -> int:
        want = self.config.o_direct if o_direct is None else o_direct
        mode = 2 if want is None else (1 if want else 0)
        if writable:
            mode |= 8  # both fds O_RDWR: the write path
        rc = self._lib.sc_register_file(self._h, os.fsencode(path), mode)
        if rc < 0:
            raise EngineError(-rc, f"register_file({path}): {os.strerror(-rc)}")
        return rc

    def unregister_file(self, file_index: int) -> None:
        self._lib.sc_unregister_file(self._h, file_index)

    def file_uses_o_direct(self, file_index: int) -> bool:
        rc = self._lib.sc_file_is_o_direct(self._h, file_index)
        if rc < 0:
            raise EngineError(-rc, os.strerror(-rc))
        return bool(rc)

    # -- pool and registered destinations -----------------------------------
    def buffer(self, buf_index: int) -> np.ndarray:
        if not 0 <= buf_index < self.config.num_buffers:
            raise IndexError(buf_index)
        start = buf_index * self.config.buffer_size
        return self._np_pool[start: start + self.config.buffer_size]

    def register_dest(self, arr: np.ndarray) -> int:
        """Register a caller slab in the ring's sparse buffer table so
        vectored gathers into it use IORING_OP_READ_FIXED (pages pinned once
        instead of per IO). Returns the table index, or -1 when the ring
        refuses (legacy table, slots exhausted, slab > 1 GiB,
        RLIMIT_MEMLOCK); refusals are counted in ``stats()``. The slab must
        stay mapped until it is unregistered or the engine closes."""
        from strom_torch.delivery.buffers import buf_addr

        nbytes = arr.nbytes
        addr = buf_addr(arr)
        with self._dest_lock:
            if self._closed:
                return -1
            rc = -1
            if nbytes <= (1 << 30):  # the kernel's cap per registered entry
                rc = self._lib.sc_register_dest(self._h, ctypes.c_void_p(addr),
                                                nbytes)
            if rc < 0:
                self._dest_refused += 1
                return -1
            self._dest_regs[addr] = (rc, nbytes)
            return rc

    def unregister_dest(self, arr: np.ndarray) -> None:
        from strom_torch.delivery.buffers import buf_addr

        self.unregister_dest_addr(buf_addr(arr))

    def unregister_dest_addr(self, addr: int) -> None:
        with self._dest_lock:
            if self._closed:
                return
            reg = self._dest_regs.pop(addr, None)
            if reg is not None:
                self._lib.sc_unregister_dest(self._h, reg[0])

    def _dest_index(self, base: int, need: int) -> int:
        """Registered-buffer table index whose entry covers
        [base, base+need), or -1. A gather often lands in a view of a
        registered slab; the kernel bounds-checks READ_FIXED addresses
        against the whole entry, so an interior match rides the fixed path
        like an exact one."""
        with self._dest_lock:
            reg = self._dest_regs.get(base)
            if reg is not None and need <= reg[1]:
                return reg[0]
            for addr, (idx, ln) in self._dest_regs.items():
                if addr <= base and base + need <= addr + ln:
                    return idx
        return -1

    # -- submit / wait ------------------------------------------------------
    def submit(self, requests: Sequence[ReadRequest]) -> int:
        for r in requests:
            rc = self._lib.sc_submit_read(self._h, r.file_index, r.offset,
                                          r.length, r.buf_index, r.buf_offset,
                                          r.tag)
            if rc < 0:
                raise EngineError(-rc, f"submit: {os.strerror(-rc)}")
        self._note_submitted(requests)
        return len(requests)

    def submit_raw(self, requests: Sequence[RawRead | RawWrite]) -> int:
        """Batch submit through sc_submit_raw_batch: one ctypes call and one
        io_uring_enter for the whole sequence. All-or-nothing in the common
        case: a batch that cannot fit the queue depth raises EAGAIN with
        nothing submitted. If a concurrent submitter races past the check
        and only part is accepted, the EngineError carries ``.accepted``,
        the count of ops already in flight: reap them and resubmit only
        ``requests[accepted:]``."""
        if not requests:
            return 0
        if self.in_flight() + len(requests) > self.config.queue_depth:
            raise EngineError(
                _errno.EAGAIN,
                f"queue depth exceeded ({self.in_flight()}+{len(requests)} > "
                f"{self.config.queue_depth})")
        ops = (_ScRawOp * len(requests))()
        for i, r in enumerate(requests):
            is_write = isinstance(r, RawWrite)
            if not r.dest.flags["C_CONTIGUOUS"] or \
                    (not is_write and not r.dest.flags["WRITEABLE"]):
                raise EngineError(_errno.EINVAL,
                                  "RawRead.dest must be writable C-contiguous")
            if r.length > 0xFFFFFFFF:
                raise EngineError(_errno.EINVAL,
                                  f"op length {r.length} exceeds uint32; "
                                  "split the op (see _split_chunks)")
            if r.dest.nbytes < r.length:
                raise EngineError(_errno.EINVAL, "op buffer smaller than length")
            addr = r.dest.__array_interface__["data"][0]
            ops[i] = _ScRawOp(r.file_index, r.length, r.offset, r.tag,
                              ctypes.c_void_p(addr), -1,
                              _SC_OP_WRITE if is_write else 0)
        # keepalives before the C call: an op can complete inside
        # sc_submit_raw_batch, and a concurrent wait() must find its entry
        for r in requests:
            self._raw_keepalive[r.tag] = r.dest
        self._note_submitted(requests)
        stop = ctypes.c_int32(0)
        rc = self._lib.sc_submit_raw_batch(self._h, ops, len(requests),
                                           ctypes.byref(stop))
        if rc < 0:
            for r in requests:
                self._raw_keepalive.pop(r.tag, None)
                self._op_submit_t.pop(r.tag, None)
            raise EngineError(-rc, f"submit_raw: {os.strerror(-rc)}")
        if rc < len(requests):
            for r in requests[rc:]:
                self._raw_keepalive.pop(r.tag, None)
                self._op_submit_t.pop(r.tag, None)
            if stop.value:
                # an op the engine can never accept (bad file index/addr)
                err = EngineError(stop.value, f"submit_raw: op {rc} rejected: "
                                              f"{os.strerror(stop.value)}")
            else:
                err = EngineError(
                    _errno.EAGAIN,
                    f"submit_raw: queue full after {rc}/{len(requests)} ops "
                    "(reap completions, then resubmit requests[accepted:])")
            err.accepted = rc
            raise err
        return rc

    def wait(self, min_completions: int = 1,
             timeout_s: float | None = None) -> list[Completion]:
        timeout_ms = -1 if timeout_s is None else max(0, int(timeout_s * 1000))
        n = self._lib.sc_wait(self._h, self._comp_buf, len(self._comp_buf),
                              min_completions, timeout_ms)
        if n < 0:
            raise EngineError(-n, f"wait: {os.strerror(-n)}")
        out = [Completion(self._comp_buf[i].tag, self._comp_buf[i].res)
               for i in range(n)]
        if self._raw_keepalive:
            for c in out:
                self._raw_keepalive.pop(c.tag, None)
        if out:
            self._note_completed(out)
        return out

    def in_flight(self) -> int:
        return self._lib.sc_in_flight(self._h)

    # -- the native gather --------------------------------------------------
    def read_vectored(self, chunks: Sequence[tuple[int, int, int, int]],
                      dest: np.ndarray, *, retries: int = 1) -> int:
        """The whole gather inside libstrom_core (sc_read_vectored), the GIL
        released for the entire transfer. Raises EngineError; ENODATA means
        a short read (range past EOF)."""
        if not chunks:
            return 0
        d8 = dest.view(np.uint8).reshape(-1)
        if not d8.flags["C_CONTIGUOUS"] or not d8.flags["WRITEABLE"]:
            raise EngineError(_errno.EINVAL, "dest must be writable C-contiguous")
        need = max(do + ln for (_, _, do, ln) in chunks)
        if d8.nbytes < need:
            raise EngineError(_errno.EINVAL, "dest smaller than gather plan")
        chunks = _split_chunks(chunks)
        segs = (_ScVecSeg * len(chunks))()
        for i, (fi, fo, do, ln) in enumerate(chunks):
            segs[i] = _ScVecSeg(fi, ln, fo, do)
        base = d8.__array_interface__["data"][0]
        res = self._lib.sc_read_vectored(self._h, segs, len(chunks),
                                         ctypes.c_void_p(base),
                                         self.config.block_size, retries,
                                         self._dest_index(base, need))
        if res < 0:
            if -res == _errno.ENODATA:
                raise EngineError(_errno.ENODATA, "short read — file smaller "
                                                  "than requested range?")
            raise EngineError(-res, f"read failed after {retries + 1} attempts: "
                                    f"{os.strerror(-res)}")
        return int(res)

    # -- observability and lifecycle ----------------------------------------
    def stats(self) -> dict:
        s = _ScStats()
        self._lib.sc_get_stats(self._h, ctypes.byref(s))
        total = s.lat_count
        out = {
            "engine": self.name,
            "ops_submitted": s.ops_submitted,
            "ops_completed": s.ops_completed,
            "ops_errored": s.ops_errored,
            "ops_faulted": s.ops_faulted,
            "bytes_read": s.bytes_read,
            # full write completions (a short write counts nothing: its
            # retry rewrites the piece); unaligned writes fall back to the
            # buffered fd and count in unaligned_fallback_reads
            "ops_written": int(s.ops_written),
            "bytes_written": int(s.bytes_written),
            "unaligned_fallback_reads": s.unaligned_fallback_reads,
            "eof_topup_reads": s.eof_topup_reads,
            "in_flight": s.in_flight,
            "chunk_retries": s.chunk_retries,
            "fixed_buffers": bool(s.fixed_buffers),
            "fixed_files": bool(s.fixed_files),
            "mlocked": bool(s.mlocked),
            "coop_taskrun": bool(s.coop_taskrun),
            "sqpoll": bool(s.sqpoll),
            "sqpoll_wakeup_errno": int(s.sqpoll_wakeup_errno),
            # the route each gather chunk was given (cache-resident bytes
            # through the buffered fd, the rest O_DIRECT from media);
            # residency is snapshotted once per gather
            "cached_bytes": int(s.cached_bytes),
            "media_bytes": int(s.media_bytes),
            "residency_probes": int(s.residency_probes),
            "sparse_table": bool(s.sparse_table),
            "ext_buffers": int(s.ext_buffers),
            "dest_refused": self._dest_refused,
            "ops_fixed": int(s.ops_fixed),
            # share of ops that rode READ_FIXED
            "engine_fixed_buf_ratio":
                (s.ops_fixed / s.ops_submitted) if s.ops_submitted else 0.0,
            "engine_unregistered_reads":
                max(0, int(s.ops_submitted) - int(s.ops_fixed)),
            "enter_submit_calls": int(s.enter_submit_calls),
            "sqpoll_wakeups": int(s.sqpoll_wakeups),
            "read_latency_mean_us": (s.lat_total_us / total) if total else 0.0,
            "read_latency_total_us": float(s.lat_total_us),
            "read_latency_count": total,
            # log2 buckets: bucket i ≈ [2^i, 2^(i+1)) us
            "read_latency_hist": [int(s.lat_hist[i])
                                  for i in range(_HIST_BUCKETS)],
        }
        # percentiles from the log2 histogram, at the upper bucket edge
        for q, name in ((0.5, "read_latency_p50_us"),
                        (0.99, "read_latency_p99_us")):
            acc, val = 0, 0.0
            target = q * total
            for i in range(_HIST_BUCKETS):
                acc += s.lat_hist[i]
                if total and acc >= target:
                    val = float(2 ** (i + 1))
                    break
            out[name] = val
        return out

    def close(self) -> None:
        if not self._closed:
            # reap live async tokens while the ring can still complete them
            self._cancel_live_tokens()
        # take the dest lock before flipping _closed and destroying the ring:
        # a slab unregistering from another thread would otherwise race
        # sc_destroy and call into a freed engine
        with self._dest_lock:
            if self._closed:
                return
            self._closed = True
            self._dest_regs.clear()  # registrations die with the ring
        # numpy views over the pool die with the engine's mapping: drop ours
        # first so a late use raises instead of faulting
        self._np_pool = None
        self._lib.sc_destroy(self._h)
        self._h = None

    def __del__(self) -> None:
        # GC-time close must never raise (interpreter teardown order is
        # arbitrary, module globals may be gone); an explicit close()
        # reports its own failures
        try:
            if not self._closed and self._h:
                self.close()
        except Exception:
            pass
