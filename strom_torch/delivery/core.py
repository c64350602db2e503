"""memcpy_ssd2gpu — the hot path (the port's counterpart of
``StromContext.memcpy_ssd2tpu`` in ``strom/delivery/core.py``).

Read a file range (an ExtentList, or a RAID0 striped set) with the engine,
O_DIRECT where the file allows, into a page-aligned pinned host slab
(registered with the engine's io_uring ring too, so the reads ride
``READ_FIXED``); copy the slab into a
``torch.empty(..., device=)`` tensor, allocated on a dedicated copy stream,
with ``copy_(non_blocking=True)`` on that stream; record an event and make
the caller's stream wait on it. A slab goes back to the pool only after the
copy that reads it has retired (its event completed), never when
``copy_()`` returns.

Transfers of at least ``max(overlap_min_bytes, overlap_chunk_bytes)`` are
streamed: one preallocated device tensor, and piece k+1 is read from disk
while piece k's slice copy is in flight. A CPU target takes no pool: the
result aliases a fresh slab through ``torch.from_numpy``.

With ``hot_cache_bytes > 0`` every gather (``pread``, ``memcpy_ssd2host``,
``memcpy_ssd2gpu`` streamed or not, ``stream_segments``) consults the hot
cache (``delivery/hotcache.py``) after physical planning and before engine
submission: cached ranges are copied from RAM into the gather's buffer,
only the misses reach the engine, and the bytes the engine read are
offered for admission. ``warm`` is the readahead's entry point.

With ``spill_bytes > 0`` as well, entries the hot cache evicts under byte
pressure demote to a spill file (``delivery/spill.py``), and the consult
goes RAM → spill → engine: a spill-resident range is read from the spill
file and promoted back to RAM, never read from the source.

Every engine gather goes through the multi-tenant scheduler
(``sched/scheduler.py``, ``sched_enabled``, on by default as in the
reference): a gather runs as slices, one grant a slice, billed to the
caller's *tenant*; the readahead reads as the background tenant
``"readahead"`` and spill I/O as ``"spill"``. ``sched_enabled=False`` puts
back one engine lock per whole transfer.

The write path runs the other way: ``pwrite`` and ``write_chunks`` hand
host bytes to the engine's write scatter (``Engine.write_vectored``), one
grant a slice, count them in ``host2ssd_bytes``, and drop what the context
cached of the path afterwards (``invalidate_file``).

Failures: every demand gather is a traced request (``obs/request.py``)
that may carry a deadline (``deadline_s=`` on ``pread``, else
``request_deadline_s``); the scheduler's queue, its slices and the
engine's waits stop at it with ``DeadlineExceeded``. The gather's outcome
feeds a per-engine circuit breaker (``delivery/resilient.py``): the gather
that trips it, and every gather while it is open, is read by a fallback
preadv pool under the tenant's grants (``failover_reads``). With
``fault_plan`` set, the engine is wrapped in ``faults.FaultyEngine``
before anything binds it.

Observability: ``stats(sections=)`` gives the nested per-section state
(the reference's shape), every counter of it kept in the stats registry;
the SLO engine (``ctx.slo``) reads every finished request of this context;
``metrics_port`` (or ``StromContext(metrics_port=0)``) serves it live
(``obs/server.py``) with a snapshot history; ``attach_cluster`` federates
other processes' endpoints; ``attach_tuner`` (or ``tune=True``) runs the
knob autotuner over the context's surfaces against the stall
attribution's goodput.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import errno
import io
import math
import os
import queue
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import SlabPool, alloc_aligned
from strom_torch.delivery.chunk_plan import plan_chunks_multi
from strom_torch.delivery.coalesce import coalesce_chunks, coalesce_segments
from strom_torch.delivery.extents import ExtentList
from strom_torch.delivery.handle import DMAHandle, deferred_handle
from strom_torch.delivery.hotcache import HotCache
from strom_torch.delivery.resilient import ResilientIo
from strom_torch.delivery.shard import Segment, plan_sharded_read
from strom_torch.engine import make_engine
from strom_torch.engine.base import (DeadlineExceeded, Engine, EngineError,
                                     EngineStallError, may_still_write)
from strom_torch.engine.raid0 import (SIZE_SIDECAR_SUFFIX,
                                      count_stripe_windows, plan_stripe_reads,
                                      plan_stripe_windows)
from strom_torch.engine.resilience import RESILIENCE_FIELDS, classify_errno
from strom_torch.obs import request as _request
from strom_torch.obs.events import ring as _events_ring
from strom_torch.probe.fiemap import fiemap
from strom_torch.utils import locks as _locks
from strom_torch.utils.stats import global_stats
from strom_torch.utils.tracing import trace_span

# the steps section of stats() is recomputed at most this often: a
# whole-ring attribution is not free
_STEPS_TTL_S = 2.0

# the registry counters of stats()["decode"] (the reference's keys)
_DECODE_COUNTERS = (
    "decode_reduced_hits_2", "decode_reduced_hits_4",
    "decode_reduced_hits_8", "decode_slot_bytes", "decode_errors",
    "decode_put_overlap_ms", "decode_native_imgs",
    "decode_native_fallbacks", "decode_fused_runs", "decode_fused_samples",
    "decode_roi_hits", "decode_roi_rows_skipped", "decode_cache_hits",
    "decode_cache_misses", "decode_cache_hit_bytes",
    "decode_cache_admitted_bytes")


def _hist_fields(name: str) -> dict:
    """A registry histogram's keys in a stats section (the reference's)."""
    h = global_stats.histogram(name)
    return {f"{name}_p50_us": h.percentile(0.50),
            f"{name}_mean_us": h.mean_us, f"{name}_total_us": h.total_us,
            f"{name}_count": h.count, f"{name}_hist": list(h.buckets)}


class _Retired:
    """The event of a copy that already ran (a CPU target's)."""

    @staticmethod
    def synchronize() -> None:
        return None


_RETIRED = _Retired()


@dataclasses.dataclass(frozen=True)
class StripedFile:
    """A logical file striped RAID0-style over member files or devices:
    logical chunk k lives on member k % n at member chunk k // n, the
    kernel's md-raid0 map applied before submission."""

    members: tuple[str, ...]
    chunk: int
    # logical size override: a set striped with zero padding to a full
    # stripe width (engine/raid0.stripe_file) reports its true size here
    size_bytes: int | None = None

    @property
    def size(self) -> int:
        if self.size_bytes is not None:
            return self.size_bytes
        # cached: read per transfer, and a mid-run rewrite of the sidecar
        # must not shift the perceived EOF
        cached = getattr(self, "_size_cache", None)
        if cached is not None:
            return cached
        sizes = [os.stat(m).st_size for m in self.members]
        capacity = min(sizes) // self.chunk * self.chunk * len(self.members)
        size = capacity
        # sets written by stripe_file carry their true size in a sidecar; a
        # stale one (members re-striped under it) is trusted only when the
        # members can hold what it claims
        try:
            with open(self.members[0] + SIZE_SIDECAR_SUFFIX) as f:
                claimed = int(f.read())
            if 0 < claimed <= capacity:
                size = claimed
        except (OSError, ValueError):
            pass
        object.__setattr__(self, "_size_cache", size)
        return size


# anything memcpy_ssd2gpu can read from
Source = str | StripedFile | ExtentList


def source_size(source: Source) -> int:
    return source.size if isinstance(source, (StripedFile, ExtentList)) \
        else os.stat(source).st_size


def resolve_device(device: Any) -> torch.device:
    """The target device: *device* as given, else the current CUDA device.
    Never the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(device: torch.device):
    """*device* as the calling thread's current CUDA device for a block: a
    thread starts on card 0, whichever card its process drives, and the
    runtime calls of a copy (pinning a slab, making an event) belong on
    the target's. Nothing for the CPU, nor for a device without an index
    (the current one)."""
    if device.type == "cuda" and device.index is not None:
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def split_segments(segments: Sequence[Segment], chunk: int
                   ) -> list[tuple[int, int, list[Segment]]]:
    """Cut a dest-contiguous segment list into pieces of <= *chunk* dest
    bytes: [(piece_dest_base, piece_nbytes, [Segment(dest rebased to 0)])],
    tiling the dest space in order."""
    segs = sorted(segments, key=lambda s: s.dest_offset)
    total = sum(s.length for s in segs)
    pieces: list[tuple[int, int, list[Segment]]] = []
    base = 0
    si = 0
    within = 0  # consumed bytes of segs[si]
    while base < total:
        take = min(chunk, total - base)
        out: list[Segment] = []
        need = take
        while need > 0:
            s = segs[si]
            part = min(need, s.length - within)
            out.append(Segment(s.file_offset + within,
                               (s.dest_offset + within) - base, part))
            within += part
            need -= part
            if within == s.length:
                si += 1
                within = 0
        pieces.append((base, take, out))
        base += take
    return pieces


class SourceIO(io.RawIOBase):
    """A seekable read-only file over any Source, reading through
    ``ctx.pread``: indexing a tar on a striped set, say. Small reads are
    served from a *readahead* window, one engine gather per window, since a
    tar header walk reads 512 bytes per member."""

    def __init__(self, ctx: "StromContext", source: Source,
                 readahead: int = 1 << 20):
        self._ctx = ctx
        self._source = source
        self._size = source_size(ctx.resolve_source(source))
        self._pos = 0
        self._ra = max(readahead, 1)
        self._buf = b""
        self._buf_off = 0  # source offset of _buf[0]

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        try:
            base = {io.SEEK_SET: 0, io.SEEK_CUR: self._pos,
                    io.SEEK_END: self._size}[whence]
        except KeyError:
            raise ValueError(f"unsupported whence {whence}") from None
        pos = base + offset
        if pos < 0:
            raise ValueError(f"negative seek position {pos}")
        self._pos = pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self._size - self._pos
        n = min(n, self._size - self._pos)
        if n <= 0:
            return b""
        lo = self._pos - self._buf_off
        if not (0 <= lo and lo + n <= len(self._buf)):
            fetch = min(max(n, self._ra), self._size - self._pos)
            self._buf = self._ctx.pread(self._source, self._pos,
                                        fetch).tobytes()
            self._buf_off = self._pos
            lo = 0
        data = self._buf[lo: lo + n]
        self._pos += len(data)
        return data


class _SpillEngineIo:
    """Routes the spill tier's I/O through the context's engine: demotion
    writes and spill-serve reads go O_DIRECT where the spill file's file
    system allows it, granted by the scheduler as the background class and
    billed to the tenant ``"spill"``. ``write`` and ``read`` return False
    whenever enqueueing is unsafe or fails, and the tier then takes its
    buffered fd (counted ``spill_fallback_ops``). Unsafe means the calling
    thread already holds a grant, or, for writes, that any exclusive grant
    is outstanding: a demotion fired by an admission in the middle of a
    streamed gather must not queue behind the grant that gather's own
    progress releases. None of it runs under the tier's lock."""

    def __init__(self, ctx, path: str):
        self._ctx = ctx
        self._path = path
        self._closed = False
        self.errors = 0

        # registered at once (the tier made the file): O_DIRECT asked for,
        # plain where the file system refuses it
        def _reg(writable: bool) -> int:
            try:
                return ctx.engine.register_file(path, o_direct=True,
                                                writable=writable)
            except OSError:
                return ctx.engine.register_file(path, o_direct=False,
                                                writable=writable)

        self._wfi = _reg(True)
        try:
            self._rfi = _reg(False)
        except BaseException:
            with contextlib.suppress(Exception):
                ctx.engine.unregister_file(self._wfi)
            raise

    def _safe(self, *, write: bool) -> bool:
        sched = self._ctx._scheduler
        if sched is None or self._closed or self._ctx._closed:
            return False
        if sched.held_by_me():
            return False
        return not write or sched.engine_idle()

    def _error(self) -> None:
        self.errors += 1
        self._ctx.scope.add("spill_errors")

    def write(self, data: np.ndarray, off: int) -> bool:
        if not self._safe(write=True):
            return False
        try:
            self._ctx._scheduler.write_chunks(
                [(self._wfi, off, 0, data.nbytes)], data, tenant="spill",
                retries=self._ctx.config.io_retries, priority="background")
            return True
        # an advisory route: any failure degrades to the buffered fd (the
        # bytes still land), counted
        except Exception:
            self._error()
            return False

    def read(self, dest: np.ndarray, off: int, n: int) -> bool:
        if not self._safe(write=False):
            return False
        try:
            got = self._ctx._scheduler.read_chunks(
                [(self._rfi, off, 0, n)], dest, tenant="spill",
                retries=self._ctx.config.io_retries, priority="background")
            return got == n
        except Exception:
            self._error()
            return False

    def close(self) -> None:
        self._closed = True
        for fi in (self._wfi, self._rfi):
            with contextlib.suppress(Exception):
                self._ctx.engine.unregister_file(fi)


class StromContext:
    """Owns the engine, the scheduler, the file registrations, the pinned
    slab pool, the hot cache and its spill tier, the per-device copy
    streams and the executor of async transfers.

    *scope*: the telemetry scope counters go through: None is the
    process-wide registry (``strom_torch.utils.stats.global_stats``), a
    dict of labels a scope of it, and a prebuilt scope passes through.

    *metrics_port*: None takes ``config.metrics_port`` (0 there = no
    server); a port given here serves the live endpoint on it, and 0 given
    here asks for an ephemeral port (``ctx.metrics_server.port``)."""

    def __init__(self, config: StromConfig | None = None,
                 engine: Engine | None = None, *,
                 metrics_port: "int | None" = None,
                 scope: "dict | None | object" = None):
        self.config = config or StromConfig.from_env()
        self._witness_enabled_here = False
        if self.config.debug_locks:
            # on BEFORE the engine and every subsystem lock below is built,
            # so their make_lock calls return WitnessLocks (module-level
            # locks made at import need STROM_DEBUG_LOCKS=1); close()
            # reverts it
            self._witness_enabled_here = not _locks.witness_enabled()
            _locks.enable_witness(True)
            if self.config.flight_dir:
                # a cycle's bundle lands where crash bundles go
                _locks.set_flight_dir(self.config.flight_dir)
        self.engine = engine or make_engine(self.config)
        # a fault plan wraps the engine before anything (the scheduler, the
        # resilience layer, the locks) binds it: every read this context
        # issues runs under the plan's seeded chaos
        if self.config.fault_plan:
            from strom_torch.faults import FaultPlan, FaultyEngine

            if not isinstance(self.engine, FaultyEngine):
                self.engine = FaultyEngine(
                    self.engine, FaultPlan.from_spec(self.config.fault_plan))
        if scope is None:
            self.scope = global_stats
        elif isinstance(scope, dict):
            self.scope = global_stats.scoped(**scope)
        else:
            self.scope = scope
        self.engine.set_scope(self.scope)
        self._files: dict[str, int] = {}
        # read-write registrations (file_index(writable=True)): the write
        # path's own indexes, so the read side keeps its O_RDONLY fds
        self._wfiles: dict[str, int] = {}
        # path -> StripedFile aliases (register_striped)
        self._striped: dict[str, StripedFile] = {}
        # path -> FIEMAP extent map (None: unavailable), probed once
        self._extent_maps: dict[str, list | None] = {}
        self._files_lock = _locks.make_lock("app.files")
        # without the scheduler, one gather at a time on the engine:
        # concurrent transfers must not interleave queue-depth budgets. A
        # multi-ring engine serializes per ring instead (concurrent_gathers);
        # a lock here would re-serialize the transfers its rings interleave.
        self._engine_lock = contextlib.nullcontext() \
            if self.engine.concurrent_gathers \
            else _locks.make_lock("engine.transfer")
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.config.delivery_workers),
            thread_name_prefix="strom-delivery")
        # NUMA placement (numa_affinity): submitting threads pinned to the
        # disk's home node, fresh slabs bound there before CUDA pins them
        if self.config.numa_affinity:
            from strom_torch.utils.numa import NumaAffinity

            self._numa = NumaAffinity(node=self.config.numa_node,
                                      steer_irqs=self.config.irq_affinity)
        else:
            self._numa = None
        # slabs are pinned on first use, which needs CUDA: the pool serves
        # CUDA targets only. Each slab is registered with CUDA and then with
        # the engine's ring (gathers into it ride READ_FIXED); leaving the
        # pool, it leaves the ring first and CUDA second.
        self._slab_pool = SlabPool(
            self.config.slab_pool_bytes, pin=True,
            on_alloc=self.engine.register_dest,
            on_free=self.engine.unregister_dest,
            place=self._numa.bind if self._numa is not None else None) \
            if self.config.slab_pool_bytes > 0 else None
        # the multi-tenant scheduler: per-tenant queues, priority classes,
        # a weighted fair drain at slice granularity, budgets and slab-pool
        # admission control, in place of the engine lock
        self._scheduler = None
        self._tenant_reg_lock = _locks.make_lock("app.tenant_reg")
        if self.config.sched_enabled:
            from strom_torch.sched.scheduler import IoScheduler

            self._scheduler = IoScheduler(self.engine, self.config,
                                          pool=self._slab_pool,
                                          scope=self.scope)
        # the circuit breaker and the fallback engine: every demand
        # gather's outcome feeds the breaker; while it is open, reads go to
        # the fallback under the tenant's grants
        self._resilience = ResilientIo(self.config, self.engine,
                                       scope=self.scope)
        if self._scheduler is not None:
            self._scheduler.resilience_info = self._resilience.stats
        # the per-tenant SLO engine: every finished request of this context
        # feeds its windows; burn rates show on /slo, as slo_* gauges per
        # tenant scope, and as slo_burning on tenants_info() rows
        from strom_torch.obs.slo import SloEngine

        self._slo = SloEngine(goodput_fn=self._current_goodput)
        # requests this context mints carry this token: the observer list
        # is process-wide, and two live contexts must not feed each
        # other's SLO engines
        self._req_owner: object = object()

        def _observe(req, _slo=self._slo, _own=self._req_owner):
            if req.owner is None or req.owner is _own:
                _slo.observe_request(req)

        self._slo_observer = _observe
        if self._scheduler is not None:
            self._scheduler.slo_hook = self._slo.burning
        # pipeline surfaces the autotuner can steer (register_tunable)
        self._tunables: dict = {}
        # the peer fabric (strom_torch/dist): serve_peers() starts the
        # exporter of this context's hot extents, attach_peers() wires the
        # client tier the consult probes after RAM and spill and before the
        # engine. Both None: a single host
        self._peer_tier = None
        self._peer_server = None
        self._tuner = None
        self._cluster = None
        self._metrics_server = None
        self._history = None
        # per-step stall attribution over the ring's events since now
        self._obs_t0_us = _events_ring.now_us()
        self._steps_cache: "tuple[float, dict] | None" = None
        self._steps_cache_lock = _locks.make_lock("app.steps_cache")
        # each bucket's total at the last publication: its growth goes to
        # the stall_<bucket>_us counters
        self._stall_published: dict[str, float] = {}
        self._copy_streams: dict[torch.device, torch.cuda.Stream] = {}
        # hot-set host cache: repeat traffic serves from RAM instead of the
        # engine. Its buffers are its own aligned allocations, not pool
        # slabs (see delivery/hotcache.py); bound_depth still subtracts
        # hot_cache_bytes from the pool's budget, as the reference does
        self._hot_cache = HotCache(
            self.config.hot_cache_bytes, admit=self.config.hot_cache_admit,
            block_bytes=self.config.hot_cache_block_bytes,
            scope=self.scope) \
            if self.config.hot_cache_bytes > 0 else None
        # the NVMe spill tier under the hot cache: evicted ranges demote to
        # a spill file and the consult serves them back (RAM → NVMe →
        # source)
        self._spill = None
        self._spill_io: _SpillEngineIo | None = None
        if self.config.spill_bytes > 0 and self._hot_cache is not None:
            import tempfile

            from strom_torch.delivery.spill import SpillTier

            sdir = self.config.spill_dir or tempfile.gettempdir()
            os.makedirs(sdir, exist_ok=True)
            self._spill = SpillTier(
                os.path.join(sdir,
                             f"strom-spill-{os.getpid()}-{id(self):x}.bin"),
                self.config.spill_bytes, scope=self.scope,
                compress=self.config.spill_compress)
            if self.config.spill_engine_io and self._scheduler is not None:
                # after the tier, so registration sees the file; advisory:
                # a refused registration leaves the tier its own fd
                try:
                    self._spill_io = _SpillEngineIo(self, self._spill.path)
                    self._spill.set_io(self._spill_io)
                except OSError:
                    self.scope.add("spill_errors")
            self._hot_cache.spill = self._spill
        # the vision pipeline's decoded-frame cache (attach_decoded_cache)
        self._decoded_cache = None
        # demand gathers in flight: readahead yields to them
        self._demand_lock = _locks.make_lock("app.demand")
        self._demand_reads = 0
        self._closed = False
        # the flight recorder: with a flight_dir, a watchdog samples
        # progress and pressure for the context's lifetime and dumps an
        # atomic bundle on SIGTERM, an unhandled exception, no progress,
        # or a breaker trip
        self._flight = None
        if self.config.flight_dir:
            from strom_torch.obs.flight import FlightRecorder

            self._flight = FlightRecorder(
                self.config.flight_dir, ctx=self,
                stall_s=self.config.flight_stall_s)
            if self._resilience.breaker is not None:
                flight = self._flight

                def _dump_on_trip(note: str, _f=flight) -> None:
                    with contextlib.suppress(Exception):
                        _f.dump("breaker_trip", note=note)

                self._resilience.breaker.on_trip = _dump_on_trip
        port = self.config.metrics_port if metrics_port is None \
            else metrics_port
        if port is not None and (port > 0 or metrics_port == 0):
            from strom_torch.obs.server import MetricsServer

            # the snapshot history rides with the live server, built first
            # so /history answers as soon as the port does
            if self.config.history_interval_s > 0:
                from strom_torch.obs.history import StatsHistory

                self._history = StatsHistory(
                    interval_s=self.config.history_interval_s)
            try:
                self._metrics_server = MetricsServer(
                    self.stats, port=port, flight=self._flight, ctx=self)
            except Exception:
                # a failed bind must not leak the threads just started for
                # a context that will never exist
                if self._history is not None:
                    self._history.close()
                if self._flight is not None:
                    self._flight.close()
                raise
        # registered last: a process-wide observer pointing at a context
        # whose __init__ failed would keep it alive and fed for good
        _request.add_observer(self._slo_observer)
        # the autotuner is armed last: every knob surface exists and the
        # endpoint already serves stats()["tune"]
        if self.config.tune:
            self.attach_tuner(
                profile_path=self.config.tune_profile or None)

    # -- files --------------------------------------------------------------
    def file_index(self, path: str, *, writable: bool = False) -> int:
        """The engine's file index for *path*, registered at first use.
        ``writable=True`` gives a separate read-write registration, which
        the write path takes; the read-only one is left as it is."""
        with self._files_lock:
            table = self._wfiles if writable else self._files
            idx = table.get(path)
            if idx is None:
                idx = table[path] = self.engine.register_file(
                    path, writable=writable)
            return idx

    def invalidate_file(self, path: str, *,
                        registrations: bool = True) -> None:
        """Forget what the context holds of *path*: its hot-cache entries
        (and any derived key that embeds the path), its extent map and,
        with *registrations*, its engine registrations. A write in place
        keeps the registrations (same inode, only the cached bytes are
        stale); a path that now names another inode (a tmp-and-rename
        commit) must drop them, or a cached fd reads the old file."""
        idxs: list[int] = []
        with self._files_lock:
            self._extent_maps.pop(path, None)
            if registrations:
                for table in (self._files, self._wfiles):
                    idx = table.pop(path, None)
                    if idx is not None:
                        idxs.append(idx)
        for idx in idxs:
            self.engine.unregister_file(idx)
        if self._hot_cache is not None:
            self._hot_cache.invalidate(path)

    def uses_o_direct(self, path: str) -> bool:
        """Whether reads of *path* go through O_DIRECT."""
        return self.engine.file_uses_o_direct(self.file_index(path))

    def register_striped(self, path: str,
                         striped: "StripedFile | Sequence[str]",
                         chunk: int | None = None,
                         size: int | None = None) -> StripedFile:
        """Alias *path* to a RAID0 striped set: every read addressed to the
        path, extents a format reader planned against it included, is
        stripe-decoded across the members."""
        if isinstance(striped, StripedFile):
            if chunk is not None and chunk != striped.chunk:
                raise ValueError(
                    f"chunk={chunk} conflicts with StripedFile.chunk="
                    f"{striped.chunk}; pass one or the other")
            if size is not None:
                striped = dataclasses.replace(striped, size_bytes=size)
        else:
            if chunk is None:
                # the chunk is how the members were written: a default would
                # de-interleave with the wrong geometry, silently
                raise ValueError("chunk is required when registering a "
                                 "member list: it must match the chunk the "
                                 "set was striped with")
            striped = StripedFile(tuple(striped), chunk, size)
        with self._files_lock:
            self._striped[path] = striped
        return striped

    def striped_source(self, path: str) -> StripedFile | None:
        """The StripedFile aliased to *path*, if any."""
        with self._files_lock:
            return self._striped.get(path)

    def resolve_source(self, source: Source) -> Source:
        """*source* with any registered striped alias applied."""
        if isinstance(source, str):
            with self._files_lock:
                return self._striped.get(source, source)
        return source

    @staticmethod
    def _numa_path(source: Source) -> str | None:
        """A representative file path for NUMA node discovery."""
        if isinstance(source, str):
            return source
        if isinstance(source, StripedFile):
            return source.members[0]
        if isinstance(source, ExtentList) and len(source):
            return source.extents[0].path
        return None

    def _count(self, **kv: int) -> None:
        """Add to counters of the stats registry, through this context's
        scope."""
        for k, v in kv.items():
            self.scope.add(k, v)

    @property
    def flight_recorder(self):
        """The flight recorder when ``flight_dir`` is set, else None."""
        return self._flight

    @property
    def metrics_server(self):
        """The live endpoint when one was asked for (``.port`` is the bound
        port), else None."""
        return self._metrics_server

    @property
    def slo(self):
        """The per-tenant SLO engine (:mod:`strom_torch.obs.slo`)."""
        return self._slo

    @property
    def history(self):
        """The snapshot history when the live server runs with
        ``history_interval_s > 0``, else None."""
        return self._history

    @property
    def cluster_view(self):
        """The federation view :meth:`attach_cluster` wired (the
        ``/cluster`` route), else None."""
        return self._cluster

    @property
    def tuner(self):
        """The knob autotuner when ``tune=True`` or :meth:`attach_tuner`
        ran, else None."""
        return self._tuner

    def register_tunable(self, kind: str, obj) -> None:
        """Expose a live pipeline surface (``"decode_pool"``,
        ``"readahead"``) for :func:`strom_torch.tune.standard_knobs` to
        build a knob over; the last registration of a *kind* wins."""
        self._tunables[str(kind)] = obj

    # -- the peer fabric (strom_torch/dist) ----------------------------------
    @property
    def peer_tier(self):
        """The peer extent client :meth:`attach_peers` wired, else None."""
        return self._peer_tier

    @property
    def peer_server(self):
        """The peer extent exporter :meth:`serve_peers` started, else
        None."""
        return self._peer_server

    def serve_peers(self, port: int = 0, host: str = "127.0.0.1") -> str:
        """Start the peer extent service: a bounded threaded TCP server
        exporting this context's hot-cache and spill extents by their
        ``(path, physical offset)`` keys. Its reads are billed to the
        background tenant ``"peer"`` through the scheduler, so peer
        traffic never starves local demand. Returns the bound
        ``host:port`` (port 0: an ephemeral one); idempotent."""
        if self._closed:
            raise RuntimeError("StromContext is closed")
        if self._peer_server is not None:
            return self._peer_server.addr
        if self._scheduler is not None:
            self.register_tenant("peer", priority="background")
        from strom_torch.dist.peers import PeerServer

        self._peer_server = PeerServer(
            self, host=host, port=port,
            max_conns=self.config.dist_server_max_conns)
        return self._peer_server.addr

    def attach_peers(self, peers, owner_fn=None, directory=None) -> None:
        """Wire the peer tier of the delivery consult. *peers* maps a peer
        name to its ``host:port`` (or is a list of addresses); *owner_fn*
        maps a dataset path to the name of the peer expected to hold it
        hot (None or unknown: the engine), or *directory* is a live
        :class:`~strom_torch.dist.directory.ExtentDirectory`, which
        outranks *owner_fn* and re-owns a dead host's keys. A failed fetch
        falls back to the local engine read, and a dead peer trips its
        breaker (which publishes the death to the directory). Replaces a
        tier attached before; the tier is registered as the
        ``"peer_tier"`` tunable, whose batch size and pool depth the
        autotuner steers."""
        from strom_torch.dist.peers import PeerTier

        if self._peer_tier is not None:
            self._peer_tier.close()
        self._peer_tier = PeerTier(
            peers, owner_fn=owner_fn, directory=directory,
            scope=self.scope,
            timeout_s=self.config.dist_peer_timeout_s,
            plan=getattr(self.engine, "plan", None),
            compress=self.config.peer_compress,
            batch_max_extents=self.config.dist_batch_max_extents,
            conn_pool_size=self.config.dist_conn_pool_size,
            auth_key=self.config.dist_auth_key)
        self.register_tunable("peer_tier", self._peer_tier)

    def peer_decoded_fetch(self, ckey) -> "np.ndarray | None":
        """Ask the owning peer for a decoded frame by its DecodedCache key
        ``("jpegdec", path, lo, hi, fingerprint)``: ``(h, w, 3)`` uint8 RGB
        or None. The vision pipeline asks on a local decoded-cache miss,
        before it plans the JPEG member's read, so a frame decoded once is
        decoded once in the cluster."""
        if self._peer_tier is None:
            return None
        try:
            _, path, lo, hi, fp = ckey
        except (TypeError, ValueError):
            return None
        return self._peer_tier.fetch_frame(str(path), int(lo), int(hi),
                                           str(fp))

    def attach_cluster(self, hosts, *, interval_s: float = 1.0,
                       stall_s: float = 10.0, **kwargs):
        """Start the cluster view: a background loop polling each worker's
        ``/stats`` (*hosts* maps a host id to its ``ip:port``), merging the
        fleet into one aggregate (served on this context's ``/cluster``)
        and flagging hosts whose scrape fails or whose progress stalls; an
        unhealthy edge asks the host for ``/flight?dump=1`` and dumps this
        context's flight recorder. Replaces any previous view; returns
        it."""
        if self._closed:
            raise RuntimeError("StromContext is closed")
        from strom_torch.obs.federation import ClusterView

        if self._cluster is not None:
            self._cluster.close()
        self._cluster = ClusterView(
            hosts, recorder=self._flight, interval_s=interval_s,
            stall_s=stall_s, **kwargs)
        return self._cluster

    def attach_tuner(self, knobs=None, *, profile_path: "str | None" = None,
                     start: bool = True):
        """Arm the closed-loop autotuner over this context's live knob
        surfaces (the scheduler's slice bytes, the cache budget and the
        registered tunables by default, or the *knobs* given; a pipeline
        adds its prefetch depth with
        :func:`strom_torch.tune.prefetcher_knob`). It climbs the stall
        attribution's goodput and holds while any tenant's SLO burns or no
        goodput is measurable yet. *profile_path* warm-starts from a saved
        :class:`strom_torch.tune.Profile`; ``start=False`` builds the
        controller without its thread (the caller beats it). Idempotent."""
        if getattr(self, "_closed", False):
            raise RuntimeError("StromContext is closed")
        if self._tuner is not None:
            return self._tuner
        from strom_torch.tune import Autotuner, Profile, standard_knobs

        ks = list(knobs) if knobs is not None else standard_knobs(self)
        name = "default"
        if profile_path:
            name = os.path.splitext(os.path.basename(profile_path))[0]
        tuner = Autotuner(
            ks, self._tune_metrics,
            interval_s=self.config.tune_interval_s,
            guard_frac=self.config.tune_guard_frac,
            scope=self.scope, profile_name=name)
        if profile_path and os.path.exists(profile_path):
            tuner.apply_profile(Profile.load(profile_path))
        self._tuner = tuner
        if start:
            tuner.start()
        return tuner

    def _tune_metrics(self) -> dict:
        """The autotuner's objective: the stall attribution's goodput (it
        rides the steps section's TTL cache). No goodput yet reads as a
        hold: the controller never experiments without a signal. With the
        history on, each bucket's ``stall_<bucket>_us`` rate rides along,
        so the controller sees where the stall time goes."""
        goodput = self._current_goodput()
        burning = bool(self._slo.stats().get("slo_tenants_burning", 0))
        metrics = {"objective": float(goodput or 0.0),
                   "slo_burning": burning or goodput is None}
        if self._history is not None:
            from strom_torch.obs.stall import BUCKETS

            for b in BUCKETS:
                r = self._history.rate(f"stall_{b}_us", window_s=30.0)
                if r is not None:
                    metrics[f"stall_{b}_us_per_s"] = r
        return metrics

    @property
    def hot_cache(self) -> HotCache | None:
        """The hot-set cache when ``hot_cache_bytes > 0``, else None."""
        return self._hot_cache

    @property
    def spill_tier(self):
        """The NVMe spill tier under the hot cache when ``spill_bytes > 0``
        (and a hot cache exists), else None."""
        return self._spill

    @property
    def resilience(self):
        """The circuit breaker and failover layer
        (:class:`strom_torch.delivery.resilient.ResilientIo`)."""
        return self._resilience

    @property
    def scheduler(self):
        """The multi-tenant I/O scheduler when ``sched_enabled``, else
        None."""
        return self._scheduler

    def register_tenant(self, name: str, *, priority: str = "training",
                        weight: int = 1, byte_rate: float = 0,
                        byte_burst: float | None = None, iops: float = 0,
                        hot_cache_bytes: int = 0):
        """Register a tenant with the scheduler (priority class, fair-drain
        weight, byte/IOPS budgets) and, with a hot cache, carve its cache
        partition, and the same partition of the spill tier. Returns the
        Tenant; raises when the scheduler is off. Registering a name again
        returns the live tenant unchanged, its partitions too. Pipelines
        name their tenant in their scope:
        ``scope={"pipeline": "resnet", "tenant": name}``."""
        if self._scheduler is None:
            raise RuntimeError("sched_enabled=False: no scheduler to "
                               "register tenants with")
        with self._tenant_reg_lock:
            if self._scheduler.is_registered(name):
                return self._scheduler.tenant(name)
            t = self._scheduler.register(
                name, priority=priority, weight=weight, byte_rate=byte_rate,
                byte_burst=byte_burst, iops=iops,
                hot_cache_bytes=hot_cache_bytes)
            if hot_cache_bytes and self._hot_cache is not None:
                self._hot_cache.set_partition(name, hot_cache_bytes)
                if self._spill is not None:
                    self._spill.set_partition(name, hot_cache_bytes)
            return t

    @contextlib.contextmanager
    def engine_exclusive(self, nbytes: int = 0, tenant: str | None = None):
        """Exclusive use of the engine's transfer path for a caller that
        drives the engine itself: a scheduler grant where there is a
        scheduler, the engine lock otherwise."""
        if self._scheduler is not None:
            with self._scheduler.grant(tenant, nbytes):
                yield
        else:
            with self._engine_lock:
                yield

    def _active_cache(self) -> HotCache | None:
        cache = self._hot_cache
        return cache if cache is not None and cache.enabled else None

    @property
    def decoded_cache(self):
        """The DecodedCache registered with :meth:`attach_decoded_cache`
        (the vision pipeline's decode-once tier), else None."""
        return self._decoded_cache

    def attach_decoded_cache(self, dcache) -> None:
        """Register a pipeline's DecodedCache: its counters show in
        :meth:`stats`, and the peer server exports its frames to the
        cluster; the last registration wins."""
        self._decoded_cache = dcache

    @contextlib.contextmanager
    def _demand_gate(self):
        """Marks a demand engine gather in flight (readahead yields to it)."""
        with self._demand_lock:
            self._demand_reads += 1
        try:
            yield
        finally:
            with self._demand_lock:
                self._demand_reads -= 1

    def _demand_active(self) -> bool:
        with self._demand_lock:
            return self._demand_reads > 0

    def extent_map(self, path: str) -> list | None:
        """Cached FIEMAP extent map for *path* (None: unavailable)."""
        with self._files_lock:
            if path in self._extent_maps:
                return self._extent_maps[path]
        try:
            em = fiemap(path)
        except OSError:
            em = None
        with self._files_lock:
            self._extent_maps[path] = em
        return em

    # -- planning and the engine gather -------------------------------------
    def _plan_chunks(self, source: Source, segments: Sequence[Segment],
                     base_offset: int = 0) -> list[tuple[int, int, int, int]]:
        """Logical (file_offset+base_offset → dest_offset) segments of a
        resolved source → physical (file_index, file_offset, dest_offset,
        length) engine ops: striped sources (and extents over a striped
        alias) stripe-decoded, fragments coalesced where contiguous in both
        file and dest space, and plain-file gathers put in physical-address
        order (``extent_aware``)."""
        return self._plan(source, segments, base_offset)[0]

    def _note_coalesce(self, n_in: int, n_out: int) -> None:
        """Engine ops before and after coalescing, summed and of the last
        transfer."""
        self.scope.add("coalesce_ops_in", n_in)
        self.scope.add("coalesce_ops_out", n_out)
        self.scope.set_gauge("coalesce_ops_in_last", n_in)
        self.scope.set_gauge("coalesce_ops_out_last", n_out)

    def _plan(self, source: Source, segments: Sequence[Segment],
              base_offset: int = 0
              ) -> tuple[list[tuple[int, int, int, int]], dict[int, str]]:
        """:meth:`_plan_chunks` and the path of every file index it used
        (the hot cache keys on physical paths)."""
        if self._numa is not None:
            # pin this thread (the engine submit path runs on it) to the
            # disk's home node; once a thread, resolved from the source
            self._numa.ensure_thread(self._numa_path(self.resolve_source(
                source)))
        cmax = self.config.coalesce_max_bytes
        if cmax and len(segments) > 1:
            # merge before expansion: a merged logical run stripes as one
            segments = coalesce_segments(segments, cmax)
        # member file indexes, resolved once per transfer
        member_cache: dict[StripedFile, list[int]] = {}
        idx_paths: dict[int, str] = {}   # file index -> path, for FIEMAP
        chunks: list[tuple[int, int, int, int]] = []

        def findex(path: str) -> int:
            idx = self.file_index(path)
            idx_paths[idx] = path
            return idx

        def stripe_chunks(sf: StripedFile, file_off: int, dest_off: int,
                          length: int) -> None:
            member_idx = member_cache.get(sf)
            if member_idx is None:
                member_idx = member_cache[sf] = [findex(m) for m in sf.members]
            segs = plan_stripe_reads(file_off, length, len(sf.members),
                                     sf.chunk)
            wb = self.config.resolved_stripe_window_bytes
            if wb > 0 and len(sf.members) > 1 and length > wb:
                # per-member sequential runs inside windows of the in-flight
                # budget, not a round-robin hopping members every chunk
                self.scope.add("stripe_windows", count_stripe_windows(
                    segs, len(sf.members), wb))
                segs = plan_stripe_windows(segs, len(sf.members), wb)
                self.scope.set_gauge("stripe_overlap_window_bytes", wb)
            chunks.extend((member_idx[s.member], s.member_offset,
                           dest_off + (s.logical_offset - file_off), s.length)
                          for s in segs)

        if isinstance(source, StripedFile):
            for seg in segments:
                stripe_chunks(source, base_offset + seg.file_offset,
                              seg.dest_offset, seg.length)
        elif isinstance(source, ExtentList):
            # runs over a striped alias gather per StripedFile and coalesce
            # before expansion, so adjacent extents stripe (and window) as
            # one run
            striped_runs: dict[StripedFile, list[Segment]] = {}
            for seg in segments:
                for r in source.locate(base_offset + seg.file_offset,
                                       seg.length, seg.dest_offset):
                    sf = self.striped_source(r.path)
                    if sf is not None:
                        striped_runs.setdefault(sf, []).append(
                            Segment(r.offset, r.dest_offset, r.length))
                    else:
                        chunks.append((findex(r.path), r.offset,
                                       r.dest_offset, r.length))
            for sf, runs in striped_runs.items():
                if cmax and len(runs) > 1:
                    n_in = len(runs)
                    runs = coalesce_segments(runs, cmax)
                    self._note_coalesce(n_in, len(runs))
                for s in runs:
                    stripe_chunks(sf, s.file_offset, s.dest_offset, s.length)
        else:
            fi = findex(source)
            chunks = [(fi, base_offset + s.file_offset, s.dest_offset, s.length)
                      for s in segments]
        if cmax and len(chunks) > 1 and not member_cache:
            # striped gathers are exempt: member ops interleave by design,
            # and their fragments merged at the segment level above
            n_in = len(chunks)
            chunks = coalesce_chunks(chunks, cmax)
            self._note_coalesce(n_in, len(chunks))
        if self.config.extent_aware and chunks and not member_cache:
            # per-file runs, each in physical-address order. Striped gathers
            # are exempt: the engine submits in list order within a
            # queue-depth window, so regrouping the member interleave into
            # per-member runs would serialize the devices RAID0 spreads over
            maps = {fi: em for fi, p in idx_paths.items()
                    if (em := self.extent_map(p))}
            if maps:
                chunks = plan_chunks_multi(chunks, maps)
        return chunks, idx_paths

    def _consult_cache(self, cache: "HotCache | None",
                       chunks: list[tuple[int, int, int, int]],
                       idx_paths: dict[int, str],
                       dflat: "np.ndarray | None", *, warm: bool = False,
                       tenant: "str | None" = None
                       ) -> tuple[list[tuple[int, int, int, int]], int,
                                  list[tuple[int, int]]]:
        """Split every physical chunk into served ranges (copied into
        *dflat*) and miss runs (the only ops the engine sees). Returns
        ``(miss_chunks, hit_bytes, hit_ranges)``: *hit_ranges* are the dest
        [lo, hi) spans served without the engine, which the streamed
        gather reports as instant completions. ``warm=True`` (readahead)
        records nothing and copies nothing (*dflat* may be None).

        The order is RAM → spill → peers → engine. RAM hits are copied
        under a pin that blocks eviction. With a spill tier, RAM misses
        probe the spill file next: a spill-resident range is read from it
        into *dflat* and offered back to RAM (admission policy applies;
        *tenant*'s partition is charged), and counts as a hit, never as
        ``cache_miss_bytes``; on the warm path it is promoted to RAM at
        once (``spill_promote_bytes``). With a peer tier
        (:meth:`attach_peers`), the ranges neither tier holds are
        collected and asked of their owners in one ``fetch_many`` (one
        round trip an owner's chunk): a peer-served range is a hit,
        promoted into the local cache, and a failed fetch falls to the
        engine. *cache* may be None (a peered context without a hot
        cache still asks its peers); the warm path never asks peers."""
        cache_hit = 0
        peer_hit = 0
        spill_served = 0
        t0 = _events_ring.now_us()
        miss_chunks: list[tuple[int, int, int, int]] = []
        hit_ranges: list[tuple[int, int]] = []
        pinned: list = []
        spill = cache.spill if cache is not None else None
        peers = self._peer_tier if (not warm and dflat is not None) else None
        # ranges neither RAM nor spill holds, for the peers:
        # (fi, path, fo, do, s, t, count_miss)
        peer_pending: list = []

        def true_miss(fi: int, path: str, fo: int, do: int, s: int, t: int,
                      count_miss: bool) -> None:
            """[s, t) is in neither tier: the peers' (resolved in one batch
            below), else the engine's. *count_miss*: the lookup left miss
            counting to the caller (a peer hit is no cache miss)."""
            if peers is not None:
                peer_pending.append((fi, path, fo, do, s, t, count_miss))
                return
            miss_chunks.append((fi, s, do + (s - fo), t - s))
            if count_miss and not warm:
                cache.note_miss(t - s)

        try:
            for fi, fo, do, ln in chunks:
                path = idx_paths.get(fi)
                if path is None:  # an untracked file index: bypass the cache
                    miss_chunks.append((fi, fo, do, ln))
                    continue
                if cache is None:
                    # peers but no hot cache: every range misses locally
                    true_miss(fi, path, fo, do, fo, fo + ln, False)
                    continue
                hits, misses, pins = cache.lookup(
                    path, fo, fo + ln, record=not warm,
                    count_misses=spill is None and peers is None)
                pinned.extend(pins)
                for s, t, view in hits:
                    if not warm:
                        dflat[do + (s - fo): do + (t - fo)] = view
                        hit_ranges.append((do + (s - fo), do + (t - fo)))
                    cache_hit += t - s
                if spill is None:
                    for s, t in misses:
                        true_miss(fi, path, fo, do, s, t, peers is not None)
                    continue
                for s, t in misses:
                    sp_hits, sp_misses = spill.lookup(path, s, t,
                                                      record=not warm)
                    try:
                        for ss, tt, ent in sp_hits:
                            n = tt - ss
                            if warm:
                                # an upcoming range promotes now: one read
                                # of the spill file on the readahead thread
                                tmp = np.empty(n, np.uint8)
                                try:
                                    spill.read_into(ent, ss, tt, tmp)
                                    promoted = cache.admit(
                                        path, ss, tt, tmp, force=True,
                                        tenant=tenant)
                                except OSError:
                                    promoted = 0
                                if promoted:
                                    spill.note_promote(promoted)
                                cache_hit += n
                                continue
                            d_lo = do + (ss - fo)
                            spill.read_into(ent, ss, tt,
                                            dflat[d_lo: d_lo + n])
                            hit_ranges.append((d_lo, d_lo + n))
                            cache_hit += n
                            spill_served += n
                            cache.admit(path, ss, tt, dflat[d_lo: d_lo + n],
                                        tenant=tenant)
                    finally:
                        spill.unpin([e for _, _, e in sp_hits])
                    for ss, tt in sp_misses:
                        true_miss(fi, path, fo, do, ss, tt, True)
            if peer_pending:
                got = peers.fetch_many(
                    [(path, s, t) for _, path, _, _, s, t, _ in peer_pending])
                for (fi, path, fo, do, s, t, count_miss), data in zip(
                        peer_pending, got):
                    d_lo = do + (s - fo)
                    if data is None:
                        miss_chunks.append((fi, s, d_lo, t - s))
                        if count_miss and not warm:
                            cache.note_miss(t - s)
                        continue
                    dflat[d_lo: d_lo + (t - s)] = data
                    hit_ranges.append((d_lo, d_lo + (t - s)))
                    cache_hit += t - s
                    peer_hit += t - s
                    if cache is not None:
                        # promoted as a spill hit is: the next read is a
                        # RAM hit, and this host can serve it onward
                        cache.admit(path, s, t, dflat[d_lo: d_lo + (t - s)],
                                    tenant=tenant)
        finally:
            if cache is not None:
                cache.unpin(pinned)
        if not warm:
            now = _events_ring.now_us()
            # request-tagged: which request the tiers served, and from where
            if spill_served:
                _request.complete(t0, now - t0, "cache", "spill.serve",
                                  {"bytes": spill_served})
            if peer_hit:
                _request.complete(t0, now - t0, "dist", "peer.serve",
                                  {"bytes": peer_hit})
            if cache_hit - peer_hit > 0:
                _request.complete(t0, now - t0, "cache", "cache.serve",
                                  {"bytes": cache_hit - peer_hit})
        return miss_chunks, cache_hit, hit_ranges

    def _read_segments(self, source: Source, segments: Sequence[Segment],
                       dest: "np.ndarray | None", base_offset: int = 0, *,
                       _warm: bool = False, tenant: str | None = None,
                       deadline_s: "float | None" = None) -> int:
        """Read (file_offset+base_offset → dest_offset) segments into *dest*,
        chunked at block_size, pipelined at queue_depth. Raises EngineError
        on any failed or short chunk.

        The hot cache (when on) is consulted after physical planning and
        before engine submission: cached and spilled ranges are copied into
        *dest*, the misses go to the engine, and the bytes it read are
        offered for admission. The engine gather runs as the scheduler's
        slices, billed to *tenant* (one engine lock for the whole transfer
        with ``sched_enabled=False``). ``_warm=True`` is the readahead path
        (:meth:`warm`): cached ranges are skipped, *dest* may be None,
        misses are read in engine-budget slices that yield to demand reads
        and force-admitted, and a short pass returns quietly.

        A demand gather is (or joins) a traced ``gather`` request; a
        request it mints carries *deadline_s* (else the config's
        ``request_deadline_s``). Its outcome feeds the circuit breaker,
        which may send it to the fallback engine (:meth:`_demand_read`)."""
        if _warm:
            chunks, idx_paths = self._plan(source, segments, base_offset)
            cache = self._active_cache()
            if cache is None:
                return 0
            if chunks:
                chunks, _, _ = self._consult_cache(cache, chunks, idx_paths,
                                                   None, warm=True,
                                                   tenant=tenant)
            return self._warm_read_chunks(cache, chunks, dest, idx_paths,
                                          tenant)
        with _request.active("gather", tenant, owner=self._req_owner) as req:
            # a deadline binds a gather request only: a pipeline's
            # enclosing batch or step request keeps its own contract
            if req.kind == "gather":
                req.set_deadline_s(deadline_s if deadline_s is not None
                                   else (self.config.request_deadline_s
                                         or None))
            chunks, idx_paths = self._plan(source, segments, base_offset)
            return self._demand_read(chunks, idx_paths, dest, tenant)

    def _demand_read(self, chunks: list[tuple[int, int, int, int]],
                     idx_paths: dict[int, str], dest: np.ndarray,
                     tenant: str | None) -> int:
        """The demand half of :meth:`_read_segments` after planning: the
        cache consult, the engine gather under the breaker (one grant a
        slice, failover slices too), the byte check and the admissions."""
        cache = self._active_cache()
        cache_hit = 0
        dflat = None
        if (cache is not None or self._peer_tier is not None) and chunks:
            dflat = dest if dest.ndim == 1 and dest.dtype == np.uint8 \
                else dest.reshape(-1).view(np.uint8)
            chunks, cache_hit, _ = self._consult_cache(
                cache, chunks, idx_paths, dflat, tenant=tenant)
        planned = sum(ln for (_, _, _, ln) in chunks)
        total = 0
        if chunks:
            retries = self.config.io_retries
            sched = self._scheduler

            def primary() -> int:
                if sched is not None:
                    return sched.read_chunks(chunks, dest, tenant=tenant,
                                             retries=retries)
                with self._engine_lock:
                    return self.engine.read_vectored(chunks, dest,
                                                     retries=retries)

            def arbitrate(read_slice) -> int:
                # failover reads stay under the tenant's grants, one a
                # slice, as the primary's; a thread that already holds a
                # grant (a spill demotion's) must not queue for another
                if sched is None or sched.held_by_me():
                    return read_slice(chunks)
                n = 0
                for sl in sched.iter_slices(chunks):
                    with sched.grant(tenant, sum(c[3] for c in sl)):
                        n += read_slice(sl)
                return n

            try:
                with self._demand_gate(), \
                        _request.span("strom.read_segments", cat="read",
                                      args={"ops": len(chunks),
                                            "bytes": planned}):
                    total = self._resilience.execute(
                        primary, chunks, dest, idx_paths,
                        arbitrate=arbitrate)
            except (DeadlineExceeded, EngineStallError):
                raise   # typed failures keep their class
            except EngineError as e:
                raise EngineError(e.errno, f"ssd2gpu {e.strerror}") from None
        if total != planned:
            raise EngineError(errno.EIO,
                              f"ssd2gpu read {total} bytes, planned {planned}")
        if cache is not None and chunks:
            # the engine already landed the bytes: admitting is one memcpy
            # into a cache buffer (the admission policy decides)
            t0a = _events_ring.now_us()
            admitted = 0
            for fi, fo, do, ln in chunks:
                path = idx_paths.get(fi)
                if path is not None:
                    admitted += cache.admit(path, fo, fo + ln,
                                            dflat[do: do + ln], tenant=tenant)
            if admitted:
                _request.complete(t0a, _events_ring.now_us() - t0a,
                                  "cache", "cache.admit",
                                  {"bytes": admitted})
        self._count(ssd2gpu_bytes=total + cache_hit)
        return total + cache_hit

    def _warm_read_chunks(self, cache: HotCache,
                          chunks: list[tuple[int, int, int, int]],
                          dest: "np.ndarray | None",
                          idx_paths: dict[int, str],
                          tenant: "str | None" = None) -> int:
        """Readahead engine path: read miss chunks in slices of the
        in-flight budget (queue_depth × block_size), force-admitting each
        slice into *tenant*'s partition, and stop when a demand gather is
        in flight, so a demand read queues behind at most one warming
        slice. Under the scheduler the reads are the background tenant
        ``"readahead"``, which any demand tenant outranks, and the warm
        buffer waits for the slab pool's admission gate first. Advisory:
        engine errors and short slices end the pass quietly."""
        if not chunks:
            return 0
        cfg = self.config
        # dest only once there are misses: a fully warm window costs a
        # consult and nothing else
        if dest is None:
            span = max(do + ln for (_, _, do, ln) in chunks)
            # background memory: under slab-pool pressure it waits
            # (bounded; a refused admit skips this pass)
            if self._scheduler is not None and \
                    not self._scheduler.admission.admit(span, timeout_s=5.0):
                return 0
            dest = alloc_aligned(span)
        dflat = dest if dest.ndim == 1 and dest.dtype == np.uint8 \
            else dest.reshape(-1).view(np.uint8)
        budget = max(cfg.queue_depth * cfg.block_size, cfg.block_size)
        total = 0
        i = 0
        while i < len(chunks):
            if self._demand_active():
                cache.note_yield()
                break
            batch: list[tuple[int, int, int, int]] = []
            b = 0
            while i < len(chunks) and b < budget:
                batch.append(chunks[i])
                b += chunks[i][3]
                i += 1
            try:
                if self._scheduler is not None:
                    n = self._scheduler.read_chunks(
                        batch, dest, tenant="readahead",
                        retries=cfg.io_retries, priority="background")
                else:
                    with self._engine_lock:
                        n = self.engine.read_vectored(batch, dest,
                                                      retries=cfg.io_retries)
            except EngineError:
                break
            if n != b:
                break
            for fi, fo, do, ln in batch:
                path = idx_paths.get(fi)
                if path is not None:
                    cache.admit(path, fo, fo + ln, dflat[do: do + ln],
                                force=True, tenant=tenant)
            total += n
        return total

    def warm(self, source: Source, segments: Sequence[Segment],
             base_offset: int = 0, *, tenant: "str | None" = None) -> int:
        """The readahead's entry point (``hotcache.Readahead``): make the
        given ranges cache-resident. Serves nothing: cached ranges are
        skipped without a copy, spilled ones promoted, misses read into a
        throwaway buffer and force-admitted into *tenant*'s partition.
        Returns bytes warmed; yields (returns 0 or short) whenever a demand
        gather is in flight."""
        cache = self._active_cache()
        if cache is None or self._closed:
            return 0
        if self._demand_active():
            cache.note_yield()
            return 0
        if sum(s.length for s in segments) <= 0:
            return 0
        try:
            warmed = self._read_segments(self.resolve_source(source),
                                         segments, None, base_offset,
                                         _warm=True, tenant=tenant)
        except (EngineError, OSError, ValueError):
            warmed = 0  # advisory: readahead never turns into a crash
        if warmed:
            cache.note_readahead(warmed)
        return warmed

    # -- completion-driven gather and host reads -----------------------------
    def stream_segments(self, source: Source, segments: Sequence[Segment],
                        dest: np.ndarray, base_offset: int = 0, *,
                        tenant: str | None = None):
        """Begin a completion-driven gather of *segments* into *dest*: the
        plan ``_read_segments`` would run, submitted through the engine's
        async API so dest ranges surface as their chunks land. Returns a
        :class:`strom_torch.delivery.stream.StreamingGather` (see its
        poll/finish/close protocol); it holds a scheduler grant for
        *tenant* (or the engine lock) until its token drains."""
        from strom_torch.delivery.stream import StreamingGather

        if self._closed:
            raise RuntimeError("StromContext is closed")
        return StreamingGather(self, self.resolve_source(source), segments,
                               dest, base_offset, tenant=tenant)

    def _numa_resolve(self, source: Source) -> None:
        """Resolve the NUMA node from *source* before a slab leaves the
        pool: a slab made before would be pinned unbound for the context's
        lifetime."""
        if self._numa is not None:
            self._numa.resolve(self._numa_path(source))

    def _alloc(self, nbytes: int) -> np.ndarray:
        """Fresh page-aligned host memory, bound to the resolved NUMA node
        where there is one."""
        dest = alloc_aligned(nbytes)
        if self._numa is not None:
            self._numa.bind(dest)
        return dest

    def alloc_read_buffer(self, source: Source, nbytes: int) -> np.ndarray:
        """A fresh page-aligned host buffer for a gather from *source* that
        the caller drives itself (the streamed batch assembly), bound to
        *source*'s NUMA node as ``pread`` binds its own."""
        self._numa_resolve(self.resolve_source(source))
        return self._alloc(nbytes)

    def pread(self, source: Source, offset: int = 0,
              length: int | None = None, *,
              tenant: str | None = None,
              deadline_s: "float | None" = None) -> np.ndarray:
        """Read bytes of *source* into a fresh aligned host buffer, with no
        device copy: the path format readers take for indexes, labels and
        members before decode. *tenant*: whose scheduler queue the gather
        takes (None: the default tenant). *deadline_s* arms a request
        deadline: the read fails fast with DeadlineExceeded instead of
        waiting out a sick engine (default: ``request_deadline_s``; 0 or
        None: none). Inside an enclosing traced request (a pipeline's batch
        or step) the enclosing contract stands and *deadline_s* is not
        applied."""
        if self._closed:
            raise RuntimeError("StromContext is closed")
        source = self.resolve_source(source)
        if length is None:
            length = source_size(source) - offset
        if length == 0:
            return np.empty(0, dtype=np.uint8)
        self._numa_resolve(source)
        dest = self._alloc(length)
        self._read_segments(source, [Segment(0, 0, length)], dest, offset,
                            tenant=tenant, deadline_s=deadline_s)
        return dest

    def memcpy_ssd2host(self, source: Source, *, offset: int = 0,
                        shape: Sequence[int] | None = None,
                        dtype: Any = np.uint8, length: int | None = None,
                        out: np.ndarray | None = None,
                        tenant: str | None = None) -> np.ndarray:
        """Everything ``memcpy_ssd2gpu`` does up to the host-to-device copy:
        striped-alias resolution, extent-aware planning, residency routing
        and the engine gather, assembled zero-copy into the returned host
        array (the buffer the blocks land in is the array). Measured
        against a bare engine read, it isolates the delivery layer's host
        cost from the link's.

        *out*: a preallocated C-contiguous destination of at least the
        read's size (one registered with the engine rides READ_FIXED);
        default: a fresh page-aligned buffer."""
        if self._closed:
            raise RuntimeError("StromContext is closed")
        source = self.resolve_source(source)
        self._numa_resolve(source)
        shape, np_dtype, nbytes = self._resolve_read_shape(
            source, offset, shape, dtype, length)
        if out is None:
            dest = self._alloc(nbytes)
        else:
            if not out.flags.c_contiguous:
                # reshape(-1) of a strided view copies: the engine would
                # land bytes the caller never sees
                raise ValueError("out must be C-contiguous")
            flat = out.reshape(-1).view(np.uint8)
            if flat.nbytes < nbytes:
                raise ValueError(f"out holds {flat.nbytes} bytes, need {nbytes}")
            dest = flat[:nbytes]
        self._read_segments(source, [Segment(0, 0, nbytes)], dest, offset,
                            tenant=tenant)
        return dest.view(np_dtype).reshape(shape)

    # -- host -> device ------------------------------------------------------
    def _copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        with self._files_lock:
            s = self._copy_streams.get(device)
            if s is None:
                s = self._copy_streams[device] = torch.cuda.Stream(device=device)
            return s

    def _acquire(self, n: int, pooled: bool) -> np.ndarray:
        """A slab from the pool when *pooled* (the pool binds fresh slabs),
        else plain page-aligned memory, bound here."""
        if pooled and self._slab_pool is not None:
            return self._slab_pool.acquire(n)
        return self._alloc(n)

    def _release(self, slab: np.ndarray, pooled: bool) -> None:
        if pooled and self._slab_pool is not None:
            self._slab_pool.release(slab)

    def _release_failed(self, slab: np.ndarray, pooled: bool) -> None:
        """Give back the slab of a read that raised. Its pieces have
        drained unless an engine abandoned one (a deadline's drain grace
        or the stall watchdog ran out): then a worker may still write
        there, and the pool parks the slab instead of reusing it."""
        if pooled and self._slab_pool is not None and may_still_write(slab):
            self._slab_pool.park(slab)
        else:
            self._release(slab, pooled)

    def _retire(self, inflight: "collections.deque", pooled: bool,
                keep: int = 0) -> None:
        """Wait for the copies out of *inflight*'s (event, slab) pairs, the
        oldest first, until *keep* remain, and give each slab back. Every
        slab goes back even when a wait raises: the first error is raised
        after the loop."""
        err: BaseException | None = None
        while len(inflight) > keep:
            ev, slab = inflight.popleft()
            try:
                ev.synchronize()   # the slab's last reader has retired
            except BaseException as e:
                err = err or e
            self._release(slab, pooled)
        if err is not None:
            raise err

    def _copy_async(self, dst: torch.Tensor, slab: np.ndarray,
                    stream: "torch.cuda.Stream | None") -> Any:
        """Enqueue slab → dst on the copy stream; the returned event retires
        when the copy (and so the slab's last reader) does. A CPU target
        (*stream* None) copies at once and returns a retired event."""
        if stream is None:
            dst.copy_(torch.from_numpy(slab))
            return _RETIRED
        with torch.cuda.stream(stream):
            dst.copy_(torch.from_numpy(slab), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        return ev

    def host_batch(self, shape: Sequence[int], device: torch.device, *,
                   source: Source | None = None) -> np.ndarray:
        """A uint8 host array of *shape* to fill and then hand to
        :meth:`put_host_batch`: for a CUDA target a pinned slab from the
        pool, else plain page-aligned memory. *source*, what the array is
        filled from, resolves the NUMA node before the slab is made."""
        if source is not None:
            self._numa_resolve(self.resolve_source(source))
        nbytes = math.prod(shape)
        with on_device(device):
            return self._acquire(nbytes, device.type == "cuda").reshape(shape)

    def put_host_batch(self, host: np.ndarray, device: torch.device
                       ) -> torch.Tensor:
        """*host* (from :meth:`host_batch`) as a tensor on *device*. CUDA:
        copied on the copy stream, ordered before later work on the stream
        current at the call; the slab returns to the pool only after the
        copy that reads it has retired. CPU: a tensor aliasing *host*."""
        if device.type != "cuda":
            return torch.from_numpy(host)
        with on_device(device):
            return self._put_slab(host, device,
                                  torch.cuda.current_stream(device))

    def _put_slab(self, slab: np.ndarray, device: torch.device,
                  consumer: torch.cuda.Stream) -> torch.Tensor:
        """Copy a pool slab into a new tensor on *device*, ordered before
        later work on *consumer*; the slab goes back to the pool once the
        copy that reads it has retired (its event completed)."""
        try:
            with trace_span("strom.device_put", cat="put",
                            enabled=self.config.trace_annotations):
                out = self._device_out(slab.shape, torch_dtype(slab.dtype),
                                       device, consumer)
                ev = self._copy_async(out, slab, self._copy_stream(device))
                consumer.wait_event(ev)
                ev.synchronize()   # the slab's last reader has retired
        finally:
            self._release(slab, True)
        return out

    def _device_out(self, shape: Sequence[int], dtype: torch.dtype,
                    device: torch.device, consumer: torch.cuda.Stream
                    ) -> torch.Tensor:
        """A new tensor on *device* for the copy stream to write and
        *consumer* to read. It is allocated on the copy stream: a block
        from *consumer*'s pool may have just been freed by work still
        queued there, and the copy stream, not ordered after that work,
        would write under it. ``record_stream`` keeps the block from being
        reused before *consumer*'s reads of it have run."""
        with torch.cuda.stream(self._copy_stream(device)):
            out = torch.empty(shape, dtype=dtype, device=device)
        out.record_stream(consumer)
        return out

    def release_host_batch(self, host: np.ndarray,
                           device: torch.device) -> None:
        """Give back a :meth:`host_batch` array that was never put (its
        batch failed): only once nothing writes into it any more."""
        self._release(host, device.type == "cuda")

    def _deliver_streamed(self, source: Source, segments: Sequence[Segment],
                          base_offset: int, out: torch.Tensor,
                          tenant: str | None = None) -> torch.Tensor:
        """Pipeline one transfer: the reader thread reads piece k+1 from disk
        while piece k's slice copy into the preallocated *out* (uint8, on
        the target device) is in flight. Its slabs come from the pool for
        a CUDA target, and for any target when the pool pins nothing."""
        pool = self._slab_pool
        pooled = out.is_cuda or (pool is not None and not pool.pin)
        pieces = split_segments(segments, self.config.overlap_chunk_bytes)
        # one piece waiting + one being read + up to two copies in flight
        ready: queue.Queue = queue.Queue(maxsize=1)
        fail: list[BaseException] = []
        stop = threading.Event()

        def reader() -> None:
            try:
                for base, n, segs in pieces:
                    if stop.is_set():
                        break
                    slab = self._acquire(n, pooled)
                    try:
                        self._read_segments(source, segs, slab, base_offset,
                                            tenant=tenant)
                    except BaseException:
                        # drained (or parked if a piece was abandoned)
                        self._release_failed(slab, pooled)
                        raise
                    ready.put((base, slab))
            except BaseException as e:  # surfaced on the consumer side
                fail.append(e)
            finally:
                ready.put(None)

        t = threading.Thread(target=reader, name="strom-stream-reader",
                             daemon=True)
        t.start()
        stream = self._copy_stream(out.device) if out.is_cuda else None
        inflight: collections.deque = collections.deque()  # (event, slab)
        item: Any = ()
        try:
            while (item := ready.get()) is not None:
                base, slab = item
                dst = out[base: base + slab.nbytes]
                with trace_span("strom.device_put", cat="put",
                                enabled=self.config.trace_annotations):
                    inflight.append((self._copy_async(dst, slab, stream),
                                     slab))
                    # recycle once the copy retired
                    self._retire(inflight, pooled, keep=1)
        finally:
            stop.set()
            while item is not None:   # unblock the reader before joining
                item = ready.get()
                if item:
                    self._release(item[1], pooled)
            t.join()
            self._retire(inflight, pooled)
        if fail:
            raise fail[0]
        self._count(streamed_transfers=1)
        return out

    def _resolve_read_shape(self, source: Source, offset: int, shape, dtype,
                            length) -> tuple[tuple[int, ...], np.dtype, int]:
        """(shape, np_dtype, nbytes) of a request. shape=None → length bytes
        (length=None → to EOF)."""
        np_dtype = np.dtype(dtype)
        if shape is None:
            if length is None:
                length = source_size(source) - offset
            if length % np_dtype.itemsize:
                raise ValueError(
                    f"length {length} not a multiple of dtype itemsize")
            shape = (length // np_dtype.itemsize,)
        shape = tuple(int(s) for s in shape)
        return shape, np_dtype, math.prod(shape) * np_dtype.itemsize

    # -- the public hot path -------------------------------------------------
    def memcpy_ssd2gpu(self, source: Source, *, offset: int = 0,
                       shape: Sequence[int] | None = None,
                       dtype: Any = np.uint8,
                       length: int | None = None,
                       device: Any = None,
                       sharding: Any = None,
                       async_: bool = False,
                       tenant: str | None = None) -> "torch.Tensor | DMAHandle":
        """Read bytes from *source* and deliver them as a torch.Tensor.

        - shape/dtype: array view of the bytes (row-major on disk); shape
          None → length bytes of uint8 (length None → to EOF).
        - device: the target; None → the current CUDA device (raises when
          there is none). ``device="cpu"`` returns a tensor aliasing the
          host slab.
        - sharding: instead of *device*, a
          :class:`~strom_torch.parallel.sharding.TorchSharding` of the
          global array: this process reads only its own block's bytes
          (``plan_sharded_read``) onto its own device, and the result is
          the global ``DTensor`` over the sharding's mesh.
        - async_: return a DMAHandle at once (≙ MEMCPY_SSD2GPU_ASYNC);
          otherwise the tensor (≙ MEMCPY_SSD2GPU). The tensor is ordered
          before any later work on the stream that was current at the call.
        - tenant: whose scheduler queue the gathers take (None: the
          default tenant).
        """
        if self._closed:
            raise RuntimeError("StromContext is closed")
        if sharding is not None and device is not None:
            raise ValueError("pass device= or sharding=, not both")
        source = self.resolve_source(source)
        self._numa_resolve(source)
        shape, np_dtype, nbytes = self._resolve_read_shape(
            source, offset, shape, dtype, length)
        if nbytes <= 0:
            raise ValueError("nothing to read")
        if sharding is None:
            device = resolve_device(device)
            segs, local_shape = [Segment(0, 0, nbytes)], shape
        else:
            plans = plan_sharded_read(shape, np_dtype, sharding)
            if len(plans) != 1:
                raise ValueError(f"{sharding!r} gives this process "
                                 f"{len(plans)} devices; a process delivers "
                                 "to one (one rank, one card)")
            (plan,) = plans
            device, segs = plan.device, list(plan.segments)
            local_shape, nbytes = plan.local_shape, plan.nbytes
        tdt = torch_dtype(np_dtype)
        cuda = device.type == "cuda"
        consumer = torch.cuda.current_stream(device) if cuda else None
        cfg = self.config
        streamed = cfg.overlap_chunk_bytes > 0 and \
            nbytes >= max(cfg.overlap_min_bytes, cfg.overlap_chunk_bytes)

        def local() -> torch.Tensor:
            self._count(transfers=1)
            if streamed:
                if cuda:
                    out = self._device_out((nbytes,), torch.uint8, device,
                                           consumer)
                else:
                    out = torch.empty(nbytes, dtype=torch.uint8)
                out = self._deliver_streamed(source, segs, offset, out,
                                             tenant)
                if cuda:
                    consumer.wait_stream(self._copy_stream(device))
                return out.view(tdt).reshape(local_shape)
            slab = self._acquire(nbytes, cuda)
            try:
                self._read_segments(source, segs, slab, offset,
                                    tenant=tenant)
            except BaseException:
                self._release_failed(slab, cuda)
                raise
            if not cuda:
                return torch.from_numpy(
                    slab.view(np_dtype).reshape(local_shape))
            return self._put_slab(slab, device, consumer).view(tdt).reshape(
                local_shape)

        def run() -> torch.Tensor:
            with on_device(device):
                out = local()
            return out if sharding is None else sharding.to_global(out, shape)

        if async_:
            # the copy stream's event after the tensor's last copy: the
            # handle's block_until_ready() waits on it
            ready: list = []

            def run_async() -> torch.Tensor:
                out = run()
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(self._copy_stream(device))
                    ready.append(ev)
                return out

            return deferred_handle(run_async, self._executor, nbytes,
                                   f"{source!r}@{offset}", ready=ready)
        return run()

    # -- the write path: host bytes to the SSD through the engine ----------
    def write_chunks(self, chunks: Sequence[tuple[int, int, int, int]],
                     src: np.ndarray, *, tenant: "str | None" = None) -> int:
        """Run a planned write scatter, (file_index, file_offset,
        src_offset, length) chunks out of *src*: one scheduler grant a
        slice, billed to *tenant* (its budgets and priority apply to
        writes), or under the engine lock with ``sched_enabled=False``.
        Feeds the circuit breaker (a sick engine's write failures count
        toward a trip as read failures do), but writes never fail over: a
        half-written checkpoint on a second engine is worse than a loud
        error. Returns bytes written; raises EngineError on a failed or
        short chunk."""
        if not chunks:
            return 0
        if self._closed:
            raise RuntimeError("StromContext is closed")
        planned = sum(ln for (_, _, _, ln) in chunks)
        br = self._resilience.breaker
        try:
            with self._demand_gate():
                if self._scheduler is not None:
                    total = self._scheduler.write_chunks(
                        chunks, src, tenant=tenant,
                        retries=self.config.io_retries)
                else:
                    with self._engine_lock:
                        total = self.engine.write_vectored(
                            chunks, src, retries=self.config.io_retries)
        except (DeadlineExceeded, EngineStallError):
            raise
        except EngineError as e:
            if br is not None and \
                    classify_errno(e.errno or errno.EIO) == "transient":
                br.record_failure()
            raise EngineError(e.errno, f"host2ssd {e.strerror}") from None
        if br is not None:
            br.record_success()
        if total != planned:
            raise EngineError(errno.EIO, f"host2ssd wrote {total} bytes, "
                                         f"planned {planned}")
        self._count(host2ssd_bytes=total)
        return total

    def pwrite(self, path: str, data: "np.ndarray | bytes | memoryview",
               offset: int = 0, *, tenant: "str | None" = None,
               create: bool = True, fsync: bool = False) -> int:
        """Write *data* to ``path[offset:offset+len)`` through the engine's
        write path: the write twin of :meth:`pread`. *create* makes the
        file when it is absent; *fsync* makes the bytes durable before the
        call returns. A page-aligned buffer at an aligned offset rides
        O_DIRECT, anything else the engine's buffered fd. Afterwards the
        context forgets its cached bytes of *path* (its registrations stay:
        the inode is the same). A striped alias takes no writes. Returns
        bytes written."""
        if self._closed:
            raise RuntimeError("StromContext is closed")
        if self.striped_source(path) is not None:
            raise ValueError(f"{path} is a striped alias; the write path "
                             "writes plain files only")
        src = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) \
            else np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        n = src.nbytes
        if n == 0:
            return 0
        if create and not os.path.exists(path):
            os.close(os.open(path, os.O_WRONLY | os.O_CREAT, 0o644))
        fi = self.file_index(path, writable=True)
        try:
            total = self.write_chunks([(fi, offset, 0, n)], src,
                                      tenant=tenant)
        finally:
            # after the write, not before: a read during the write may have
            # admitted the old bytes, which invalidating first would keep
            self.invalidate_file(path, registrations=False)
        if fsync:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        return total

    # -- introspection and lifecycle -----------------------------------------
    def buffer_info(self) -> dict:
        """The engine's staging pool (≙ LIST/INFO_GPU_MEMORY)."""
        return self.engine.buffer_info()

    def stats(self, sections: "Sequence[str] | None" = None) -> dict:
        """Nested per-section stats (the ``/stats`` shape and what
        ``sections_prometheus`` renders). *sections* selects a subset by
        name, and only those are computed: a scrape that wants counters
        never recomputes the stall attribution (``steps``, which keeps its
        TTL cache). None = every section. The sections: ``context``,
        ``decode``, ``stream``, ``steps``, ``cache``, ``spill``,
        ``slab_pool``, ``engine``, ``sched``, ``slo``, ``tune``,
        ``exemplars``, ``resilience``, ``scopes`` and ``dist`` (the peer
        tier's and the peer server's counters, ``DIST_FIELDS``); ``cache``,
        ``spill``, ``slab_pool``, ``sched``, ``tune`` and ``dist`` only
        where the context has one.
        Counters are the process-wide registry's, as the reference reads
        them. No section makes a CUDA call."""
        want = None if sections is None else set(sections)

        def wanted(name: str) -> bool:
            return want is None or name in want

        c = global_stats.counter
        g = global_stats.gauge
        out: dict = {}
        if wanted("context"):
            with self._files_lock:
                nfiles = len(self._files)
            out["context"] = {
                "registered_files": nfiles,
                "ssd2gpu_bytes": c("ssd2gpu_bytes").value,
                "host2ssd_bytes": c("host2ssd_bytes").value,
                "coalesce_ops_in": c("coalesce_ops_in").value,
                "coalesce_ops_out": c("coalesce_ops_out").value,
                "coalesce_ops_in_last": g("coalesce_ops_in_last").value,
                "coalesce_ops_out_last": g("coalesce_ops_out_last").value,
                "stripe_overlap_window_bytes":
                    g("stripe_overlap_window_bytes").value,
                "stripe_windows": c("stripe_windows").value,
                # the port's own: whole-tensor and streamed deliveries
                "transfers": c("transfers").value,
                "streamed_transfers": c("streamed_transfers").value,
            }
        if wanted("decode"):
            dec = {k: c(k).value for k in _DECODE_COUNTERS}
            dec.update(_hist_fields("decode_batch"))
            out["decode"] = dec
        if wanted("stream"):
            st = {"stream_batches": c("stream_batches").value,
                  "stream_inflight_peak": g("stream_inflight_peak").value,
                  "stream_instant_bytes": c("stream_instant_bytes").value,
                  "stream_samples_early": c("stream_samples_early").value}
            for name in ("stream_first_decode_lat", "stream_tail_extent"):
                st.update(_hist_fields(name))
            # the port's own: streamed gathers (stream_segments calls)
            st["stream_gathers"] = c("stream_gathers").value
            out["stream"] = st
        if wanted("steps"):
            steps = self._steps_section()
            steps["events_dropped"] = _events_ring.events_dropped
            out["steps"] = steps
        if wanted("cache") and self._hot_cache is not None:
            out["cache"] = self._hot_cache.stats()
        if wanted("spill") and self._spill is not None:
            sp = self._spill.stats()
            sp["spill_errors"] = self._hot_cache.spill_errors + (
                self._spill_io.errors if self._spill_io is not None else 0)
            out["spill"] = sp
        if wanted("dist") and (self._peer_tier is not None
                               or self._peer_server is not None):
            d: dict = {}
            if self._peer_tier is not None:
                d.update(self._peer_tier.stats())
            if self._peer_server is not None:
                d.update(self._peer_server.stats())
            out["dist"] = d
        if wanted("slab_pool") and self._slab_pool is not None:
            out["slab_pool"] = self._slab_pool.stats()
        if wanted("engine"):
            out["engine"] = self.engine.stats()
        if wanted("sched") and self._scheduler is not None:
            out["sched"] = self._scheduler.stats()
        if wanted("slo"):
            out["slo"] = self._slo.stats()
        if wanted("tune") and self._tuner is not None:
            out["tune"] = self._tuner.stats()
        if wanted("resilience"):
            # the counters under the reference's names, from the registry,
            # and the breaker's state and the fault plan's tally
            res: dict = {k: g(k).value if k == "breaker_state"
                         else c(k).value for k in RESILIENCE_FIELDS}
            res.update(self._resilience.stats())
            plan = getattr(self.engine, "plan", None)
            if plan is not None:
                res["fault_plan"] = plan.stats()
            out["resilience"] = res
        if wanted("exemplars"):
            from strom_torch.obs.exemplars import store as _exemplars

            out["exemplars"] = _exemplars.stats()
        if wanted("scopes"):
            # every label scope's series, the JSON twin of the labelled
            # samples /metrics renders (the sections exposition skips it)
            out["scopes"] = global_stats.scopes_snapshot()
        return out

    def _steps_section(self) -> dict:
        """``goodput_pct`` and each bucket's p50/p99 over the step windows
        the ring holds from this context's lifetime (flat keys,
        :data:`strom_torch.obs.stall.STALL_FIELDS`), recomputed at most
        once every ``_STEPS_TTL_S``; each recompute adds the buckets'
        growth to the ``stall_<bucket>_us`` counters."""
        from strom_torch.obs import stall

        now = time.monotonic()
        with self._steps_cache_lock:
            cached = self._steps_cache
            if cached is not None and now - cached[0] < _STEPS_TTL_S:
                return dict(cached[1])
            # only the events of this context's lifetime become dicts: a
            # full ring of older ones made each scrape cost 0.5 s of CPU
            summary = stall.steps_summary(
                _events_ring.snapshot(since_us=self._obs_t0_us),
                lo_us=self._obs_t0_us)
            steps = stall.flatten_summary(summary)
            self._steps_cache = (now, dict(steps))
            deltas = self._stall_deltas_locked(summary)
        # counter writes outside the cache lock; the delta state was
        # settled under it, so two racing recomputes never publish the
        # same growth twice
        for k, d in deltas.items():
            global_stats.add(k, d)
        return steps

    def _stall_deltas_locked(self, summary: dict) -> "dict[str, int]":
        """Growth of each bucket's total since the last publication, as
        ``stall_<bucket>_us`` increments (caller holds
        ``_steps_cache_lock``). The window is the whole retained ring, so
        a drop-oldest wrap can shrink a total: that publishes no growth
        and re-anchors."""
        out: dict[str, int] = {}
        for b, v in summary.get("buckets", {}).items():
            total = float(v.get("total_us", 0.0))
            last = self._stall_published.get(b, 0.0)
            if total > last:
                out[f"stall_{b}_us"] = int(total - last)
            self._stall_published[b] = total
        return out

    def _current_goodput(self) -> "float | None":
        """The stall attribution's goodput (None: unknown — no step
        window yet, or a context closing mid-read)."""
        try:
            return self._steps_section().get("goodput_pct")
        except Exception:
            return None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        _request.remove_observer(self._slo_observer)
        # the tuner first: its thread reads stats() and knob surfaces about
        # to go (knobs stay where the search left them: close is no revert)
        if self._tuner is not None:
            self._tuner.close()
        # the cluster view before the server and the recorder it uses
        if self._cluster is not None:
            self._cluster.close()
        # the peer service before the engine: no serve starts a cache or
        # spill read (or a grant) on a closing context, and the consult
        # stops asking peers
        if self._peer_server is not None:
            self._peer_server.close()
        if self._peer_tier is not None:
            self._peer_tier.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
        if self._history is not None:
            self._history.close()
        if self._flight is not None:
            self._flight.close()
        self._executor.shutdown(wait=True)
        self._resilience.close()
        if self._spill_io is not None:
            # the spill file's registrations leave while the engine lives;
            # the tier keeps its own fd until it closes
            self._spill.set_io(None)
            self._spill_io.close()
        self.engine.close()
        if self._spill is not None:
            # after the engine: no gather can be mid-consult any more
            self._hot_cache.spill = None
            self._spill.close()
        for s in list(self._copy_streams.values()):
            # no copy reads a slab any more; a stream in an error state
            # (a broken capture) runs no copy either
            with contextlib.suppress(RuntimeError):
                s.synchronize()
        if self._slab_pool is not None:
            # every registered slab leaves, those still out too: none may
            # outlive the pool while registered
            self._slab_pool.close()
        if self._witness_enabled_here:
            # later contexts' locks go back to plain ones; locks already
            # built as WitnessLocks keep witnessing
            _locks.enable_witness(False)

    def __enter__(self) -> "StromContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
