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
from strom_torch.delivery.shard import Segment
from strom_torch.engine import make_engine
from strom_torch.engine.base import Engine, EngineError
from strom_torch.engine.raid0 import (SIZE_SIDECAR_SUFFIX, plan_stripe_reads,
                                      plan_stripe_windows)
from strom_torch.probe.fiemap import fiemap
from strom_torch.utils.stats import global_stats


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
    dict of labels a scope of it, and a prebuilt scope passes through."""

    def __init__(self, config: StromConfig | None = None,
                 engine: Engine | None = None, *,
                 scope: "dict | None | object" = None):
        self.config = config or StromConfig.from_env()
        self.engine = engine or make_engine(self.config)
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
        self._files_lock = threading.Lock()
        # without the scheduler, one gather at a time on the engine:
        # concurrent transfers must not interleave queue-depth budgets. A
        # multi-ring engine serializes per ring instead (concurrent_gathers);
        # a lock here would re-serialize the transfers its rings interleave.
        self._engine_lock = contextlib.nullcontext() \
            if self.engine.concurrent_gathers else threading.Lock()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.config.delivery_workers),
            thread_name_prefix="strom-delivery")
        # slabs are pinned on first use, which needs CUDA: the pool serves
        # CUDA targets only. Each slab is registered with CUDA and then with
        # the engine's ring (gathers into it ride READ_FIXED); leaving the
        # pool, it leaves the ring first and CUDA second.
        self._slab_pool = SlabPool(
            self.config.slab_pool_bytes, pin=True,
            on_alloc=self.engine.register_dest,
            on_free=self.engine.unregister_dest) \
            if self.config.slab_pool_bytes > 0 else None
        # the multi-tenant scheduler: per-tenant queues, priority classes,
        # a weighted fair drain at slice granularity, budgets and slab-pool
        # admission control, in place of the engine lock
        self._scheduler = None
        self._tenant_reg_lock = threading.Lock()
        if self.config.sched_enabled:
            from strom_torch.sched.scheduler import IoScheduler

            self._scheduler = IoScheduler(self.engine, self.config,
                                          pool=self._slab_pool,
                                          scope=self.scope)
        self._copy_streams: dict[torch.device, torch.cuda.Stream] = {}
        self._counts = collections.Counter(
            {"ssd2gpu_bytes": 0, "transfers": 0, "streamed_transfers": 0,
             "stream_gathers": 0, "stream_instant_bytes": 0,
             "host2ssd_bytes": 0})
        self._counts_lock = threading.Lock()
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
        self._demand_lock = threading.Lock()
        self._demand_reads = 0
        self._closed = False

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

    def _count(self, **kv: int) -> None:
        with self._counts_lock:
            self._counts.update(kv)

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
        """Register a pipeline's DecodedCache (its counters show in
        :meth:`stats`); the last registration wins."""
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

    def _plan(self, source: Source, segments: Sequence[Segment],
              base_offset: int = 0
              ) -> tuple[list[tuple[int, int, int, int]], dict[int, str]]:
        """:meth:`_plan_chunks` and the path of every file index it used
        (the hot cache keys on physical paths)."""
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
                segs = plan_stripe_windows(segs, len(sf.members), wb)
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
                    runs = coalesce_segments(runs, cmax)
                for s in runs:
                    stripe_chunks(sf, s.file_offset, s.dest_offset, s.length)
        else:
            fi = findex(source)
            chunks = [(fi, base_offset + s.file_offset, s.dest_offset, s.length)
                      for s in segments]
        if cmax and len(chunks) > 1 and not member_cache:
            # striped gathers are exempt: member ops interleave by design,
            # and their fragments merged at the segment level above
            chunks = coalesce_chunks(chunks, cmax)
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

    def _consult_cache(self, cache: HotCache,
                       chunks: list[tuple[int, int, int, int]],
                       idx_paths: dict[int, str],
                       dflat: "np.ndarray | None", *, warm: bool = False,
                       tenant: "str | None" = None
                       ) -> tuple[list[tuple[int, int, int, int]], int,
                                  list[tuple[int, int]]]:
        """Split every physical chunk into cached ranges (copied from RAM
        into *dflat* under a pin that blocks eviction) and miss runs (the
        only ops the engine sees). Returns ``(miss_chunks, hit_bytes,
        hit_ranges)``: *hit_ranges* are the dest [lo, hi) spans served
        without the engine, which the streamed gather reports as instant
        completions. ``warm=True`` (readahead) records nothing and copies
        nothing (*dflat* may be None).

        With a spill tier, RAM misses probe the spill file next: a
        spill-resident range is read from it into *dflat* and offered back
        to RAM (admission policy applies; *tenant*'s partition is charged),
        and counts as a hit, never as ``cache_miss_bytes``; only ranges
        neither tier holds do. On the warm path a spill-resident range is
        promoted to RAM at once (``spill_promote_bytes``)."""
        cache_hit = 0
        miss_chunks: list[tuple[int, int, int, int]] = []
        hit_ranges: list[tuple[int, int]] = []
        pinned: list = []
        spill = cache.spill
        try:
            for fi, fo, do, ln in chunks:
                path = idx_paths.get(fi)
                if path is None:  # an untracked file index: bypass the cache
                    miss_chunks.append((fi, fo, do, ln))
                    continue
                hits, misses, pins = cache.lookup(
                    path, fo, fo + ln, record=not warm,
                    count_misses=spill is None)
                pinned.extend(pins)
                for s, t, view in hits:
                    if not warm:
                        dflat[do + (s - fo): do + (t - fo)] = view
                        hit_ranges.append((do + (s - fo), do + (t - fo)))
                    cache_hit += t - s
                if spill is None:
                    miss_chunks.extend((fi, s, do + (s - fo), t - s)
                                       for s, t in misses)
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
                            cache.admit(path, ss, tt, dflat[d_lo: d_lo + n],
                                        tenant=tenant)
                    finally:
                        spill.unpin([e for _, _, e in sp_hits])
                    for ss, tt in sp_misses:
                        miss_chunks.append((fi, ss, do + (ss - fo), tt - ss))
                        if not warm:
                            cache.note_miss(tt - ss)
        finally:
            cache.unpin(pinned)
        return miss_chunks, cache_hit, hit_ranges

    def _read_segments(self, source: Source, segments: Sequence[Segment],
                       dest: "np.ndarray | None", base_offset: int = 0, *,
                       _warm: bool = False, tenant: str | None = None) -> int:
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
        and force-admitted, and a short pass returns quietly."""
        chunks, idx_paths = self._plan(source, segments, base_offset)
        cache = self._active_cache()
        if _warm:
            if cache is None:
                return 0
            if chunks:
                chunks, _, _ = self._consult_cache(cache, chunks, idx_paths,
                                                   None, warm=True,
                                                   tenant=tenant)
            return self._warm_read_chunks(cache, chunks, dest, idx_paths,
                                          tenant)
        cache_hit = 0
        dflat = None
        if cache is not None and chunks:
            dflat = dest if dest.ndim == 1 and dest.dtype == np.uint8 \
                else dest.reshape(-1).view(np.uint8)
            chunks, cache_hit, _ = self._consult_cache(
                cache, chunks, idx_paths, dflat, tenant=tenant)
        planned = sum(ln for (_, _, _, ln) in chunks)
        total = 0
        if chunks:
            retries = self.config.io_retries
            try:
                with self._demand_gate():
                    if self._scheduler is not None:
                        total = self._scheduler.read_chunks(
                            chunks, dest, tenant=tenant, retries=retries)
                    else:
                        with self._engine_lock:
                            total = self.engine.read_vectored(
                                chunks, dest, retries=retries)
            except EngineError as e:
                raise EngineError(e.errno, f"ssd2gpu {e.strerror}") from None
        if total != planned:
            raise EngineError(errno.EIO,
                              f"ssd2gpu read {total} bytes, planned {planned}")
        if cache is not None:
            # the engine already landed the bytes: admitting is one memcpy
            # into a cache buffer (the admission policy decides)
            for fi, fo, do, ln in chunks:
                path = idx_paths.get(fi)
                if path is not None:
                    cache.admit(path, fo, fo + ln, dflat[do: do + ln],
                                tenant=tenant)
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

    def alloc_read_buffer(self, source: Source, nbytes: int) -> np.ndarray:
        """A fresh page-aligned host buffer for a gather from *source* that
        the caller drives itself (the streamed batch assembly), as ``pread``
        allocates its own. (The reference binds it to *source*'s NUMA node;
        the port binds none.)"""
        return alloc_aligned(nbytes)

    def pread(self, source: Source, offset: int = 0,
              length: int | None = None, *,
              tenant: str | None = None) -> np.ndarray:
        """Read bytes of *source* into a fresh aligned host buffer, with no
        device copy: the path format readers take for indexes, labels and
        members before decode. *tenant*: whose scheduler queue the gather
        takes (None: the default tenant)."""
        if self._closed:
            raise RuntimeError("StromContext is closed")
        source = self.resolve_source(source)
        if length is None:
            length = source_size(source) - offset
        if length == 0:
            return np.empty(0, dtype=np.uint8)
        dest = alloc_aligned(length)
        self._read_segments(source, [Segment(0, 0, length)], dest, offset,
                            tenant=tenant)
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
        shape, np_dtype, nbytes = self._resolve_read_shape(
            source, offset, shape, dtype, length)
        if out is None:
            dest = alloc_aligned(nbytes)
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

    def _acquire(self, n: int, cuda: bool) -> np.ndarray:
        if cuda and self._slab_pool is not None:
            return self._slab_pool.acquire(n)
        return alloc_aligned(n)

    def _release(self, slab: np.ndarray, cuda: bool) -> None:
        if cuda and self._slab_pool is not None:
            self._slab_pool.release(slab)

    def _copy_async(self, dst: torch.Tensor, slab: np.ndarray,
                    stream: torch.cuda.Stream) -> torch.cuda.Event:
        """Enqueue slab → dst on the copy stream; the returned event retires
        when the copy (and so the slab's last reader) does."""
        with torch.cuda.stream(stream):
            dst.copy_(torch.from_numpy(slab), non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        return ev

    def host_batch(self, shape: Sequence[int], device: torch.device
                   ) -> np.ndarray:
        """A uint8 host array of *shape* to fill and then hand to
        :meth:`put_host_batch`: for a CUDA target a pinned slab from the
        pool, else plain page-aligned memory."""
        nbytes = math.prod(shape)
        return self._acquire(nbytes, device.type == "cuda").reshape(shape)

    def put_host_batch(self, host: np.ndarray, device: torch.device
                       ) -> torch.Tensor:
        """*host* (from :meth:`host_batch`) as a tensor on *device*. CUDA:
        copied on the copy stream, ordered before later work on the stream
        current at the call; the slab returns to the pool only after the
        copy that reads it has retired. CPU: a tensor aliasing *host*."""
        if device.type != "cuda":
            return torch.from_numpy(host)
        return self._put_slab(host, device, torch.cuda.current_stream(device))

    def _put_slab(self, slab: np.ndarray, device: torch.device,
                  consumer: torch.cuda.Stream) -> torch.Tensor:
        """Copy a pool slab into a new tensor on *device*, ordered before
        later work on *consumer*; the slab goes back to the pool once the
        copy that reads it has retired (its event completed)."""
        try:
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
        the target device) is in flight."""
        cuda = out.is_cuda
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
                    slab = self._acquire(n, cuda)
                    self._read_segments(source, segs, slab, base_offset,
                                        tenant=tenant)
                    ready.put((base, slab))
            except BaseException as e:  # surfaced on the consumer side
                fail.append(e)
            finally:
                ready.put(None)

        t = threading.Thread(target=reader, name="strom-stream-reader",
                             daemon=True)
        t.start()
        stream = self._copy_stream(out.device) if cuda else None
        inflight: collections.deque = collections.deque()  # (event, slab)
        item: Any = ()
        try:
            while (item := ready.get()) is not None:
                base, slab = item
                dst = out[base: base + slab.nbytes]
                if cuda:
                    inflight.append((self._copy_async(dst, slab, stream), slab))
                    while len(inflight) > 1:   # recycle once the copy retired
                        ev, done = inflight.popleft()
                        ev.synchronize()
                        self._release(done, cuda)
                else:
                    dst.copy_(torch.from_numpy(slab))
        finally:
            stop.set()
            while item is not None:   # unblock the reader before joining
                item = ready.get()
                if item:
                    self._release(item[1], cuda)
            t.join()
            while inflight:
                ev, done = inflight.popleft()
                ev.synchronize()
                self._release(done, cuda)
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
                       async_: bool = False,
                       tenant: str | None = None) -> "torch.Tensor | DMAHandle":
        """Read bytes from *source* and deliver them as a torch.Tensor.

        - shape/dtype: array view of the bytes (row-major on disk); shape
          None → length bytes of uint8 (length None → to EOF).
        - device: the target; None → the current CUDA device (raises when
          there is none). ``device="cpu"`` returns a tensor aliasing the
          host slab.
        - async_: return a DMAHandle at once (≙ MEMCPY_SSD2GPU_ASYNC);
          otherwise the tensor (≙ MEMCPY_SSD2GPU). The tensor is ordered
          before any later work on the stream that was current at the call.
        - tenant: whose scheduler queue the gathers take (None: the
          default tenant).
        """
        if self._closed:
            raise RuntimeError("StromContext is closed")
        device = resolve_device(device)
        source = self.resolve_source(source)
        shape, np_dtype, nbytes = self._resolve_read_shape(
            source, offset, shape, dtype, length)
        if nbytes <= 0:
            raise ValueError("nothing to read")
        tdt = torch_dtype(np_dtype)
        cuda = device.type == "cuda"
        consumer = torch.cuda.current_stream(device) if cuda else None
        cfg = self.config
        streamed = cfg.overlap_chunk_bytes > 0 and \
            nbytes >= max(cfg.overlap_min_bytes, cfg.overlap_chunk_bytes)
        segs = [Segment(0, 0, nbytes)]

        def run() -> torch.Tensor:
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
                return out.view(tdt).reshape(shape)
            slab = self._acquire(nbytes, cuda)
            try:
                self._read_segments(source, segs, slab, offset,
                                    tenant=tenant)
            except BaseException:
                self._release(slab, cuda)
                raise
            if not cuda:
                return torch.from_numpy(slab.view(np_dtype).reshape(shape))
            return self._put_slab(slab, device, consumer).view(tdt).reshape(
                shape)

        if async_:
            return deferred_handle(run, self._executor, nbytes,
                                   f"{source!r}@{offset}")
        return run()

    # -- the write path: host bytes to the SSD through the engine ----------
    def write_chunks(self, chunks: Sequence[tuple[int, int, int, int]],
                     src: np.ndarray, *, tenant: "str | None" = None) -> int:
        """Run a planned write scatter, (file_index, file_offset,
        src_offset, length) chunks out of *src*: one scheduler grant a
        slice, billed to *tenant* (its budgets and priority apply to
        writes), or under the engine lock with ``sched_enabled=False``. The
        port has no circuit breaker yet. Returns bytes written; raises
        EngineError on a failed or short chunk: nothing falls back."""
        if not chunks:
            return 0
        if self._closed:
            raise RuntimeError("StromContext is closed")
        planned = sum(ln for (_, _, _, ln) in chunks)
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
        except EngineError as e:
            raise EngineError(e.errno, f"host2ssd {e.strerror}") from None
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

    def set_counters(self, **kv: int) -> None:
        """Set counters of :meth:`stats` to values (gauges: the resume
        layer's verdict), where ``_count`` adds."""
        with self._counts_lock:
            for k, v in kv.items():
                self._counts[k] = v

    def stats(self) -> dict:
        with self._counts_lock:
            out = dict(self._counts)
        with self._files_lock:
            out["context"] = {"registered_files": len(self._files),
                              "host2ssd_bytes": out["host2ssd_bytes"]}
        out["engine"] = self.engine.stats()
        if self._slab_pool is not None:
            out["slab_pool"] = self._slab_pool.stats()
        if self._hot_cache is not None:
            out["cache"] = self._hot_cache.stats()
        if self._spill is not None:
            sp = self._spill.stats()
            sp["spill_errors"] = self._hot_cache.spill_errors + (
                self._spill_io.errors if self._spill_io is not None else 0)
            out["spill"] = sp
        if self._scheduler is not None:
            out["sched"] = self._scheduler.stats()
        if self._decoded_cache is not None:
            out["decode_cache"] = self._decoded_cache.stats()
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._executor.shutdown(wait=True)
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
        if self._slab_pool is not None:
            self._slab_pool.close()

    def __enter__(self) -> "StromContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
