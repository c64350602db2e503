"""memcpy_ssd2gpu — the hot path (the port's counterpart of
``StromContext.memcpy_ssd2tpu`` in ``strom/delivery/core.py``).

Read a file range (an ExtentList, or a RAID0 striped set) with the engine,
O_DIRECT where the file allows, into a page-aligned pinned host slab
(registered with the engine's io_uring ring too, so the reads ride
``READ_FIXED``); copy the slab into a
``torch.empty(..., device=)`` tensor with ``copy_(non_blocking=True)`` on a
dedicated copy stream; record an event and make the caller's stream wait on
it. A slab goes back to the pool only after the copy that reads it has
retired (its event completed), never when ``copy_()`` returns.

Transfers of at least ``max(overlap_min_bytes, overlap_chunk_bytes)`` are
streamed: one preallocated device tensor, and piece k+1 is read from disk
while piece k's slice copy is in flight. A CPU target takes no pool: the
result aliases a fresh slab through ``torch.from_numpy``.
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
from strom_torch.delivery.shard import Segment
from strom_torch.engine import make_engine
from strom_torch.engine.base import Engine, EngineError
from strom_torch.engine.raid0 import (SIZE_SIDECAR_SUFFIX, plan_stripe_reads,
                                      plan_stripe_windows)
from strom_torch.probe.fiemap import fiemap


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


class StromContext:
    """Owns the engine, the file registrations, the pinned slab pool, the
    per-device copy streams and the executor of async transfers."""

    def __init__(self, config: StromConfig | None = None,
                 engine: Engine | None = None):
        self.config = config or StromConfig.from_env()
        self.engine = engine or make_engine(self.config)
        self._files: dict[str, int] = {}
        # path -> StripedFile aliases (register_striped)
        self._striped: dict[str, StripedFile] = {}
        # path -> FIEMAP extent map (None: unavailable), probed once
        self._extent_maps: dict[str, list | None] = {}
        self._files_lock = threading.Lock()
        # one gather at a time on the engine: concurrent transfers must not
        # interleave queue-depth budgets. A multi-ring engine serializes per
        # ring instead (concurrent_gathers); a lock here would re-serialize
        # the very transfers its rings exist to interleave.
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
        self._copy_streams: dict[torch.device, torch.cuda.Stream] = {}
        self._counts = collections.Counter(
            {"ssd2gpu_bytes": 0, "transfers": 0, "streamed_transfers": 0,
             "stream_gathers": 0})
        self._counts_lock = threading.Lock()
        self._closed = False

    # -- files --------------------------------------------------------------
    def file_index(self, path: str) -> int:
        with self._files_lock:
            idx = self._files.get(path)
            if idx is None:
                idx = self._files[path] = self.engine.register_file(path)
            return idx

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
        return chunks

    def _read_segments(self, source: Source, segments: Sequence[Segment],
                       dest: np.ndarray, base_offset: int = 0) -> int:
        """Read (file_offset+base_offset → dest_offset) segments into *dest*,
        chunked at block_size, pipelined at queue_depth. Raises EngineError
        on any failed or short chunk."""
        chunks = self._plan_chunks(source, segments, base_offset)
        planned = sum(ln for (_, _, _, ln) in chunks)
        try:
            with self._engine_lock:
                total = self.engine.read_vectored(chunks, dest,
                                                  retries=self.config.io_retries)
        except EngineError as e:
            raise EngineError(e.errno, f"ssd2gpu {e.strerror}") from None
        if total != planned:
            raise EngineError(errno.EIO,
                              f"ssd2gpu read {total} bytes, planned {planned}")
        self._count(ssd2gpu_bytes=total)
        return total

    # -- completion-driven gather and host reads -----------------------------
    def stream_segments(self, source: Source, segments: Sequence[Segment],
                        dest: np.ndarray, base_offset: int = 0):
        """Begin a completion-driven gather of *segments* into *dest*: the
        plan ``_read_segments`` would run, submitted through the engine's
        async API so dest ranges surface as their chunks land. Returns a
        :class:`strom_torch.delivery.stream.StreamingGather` (see its
        poll/finish/close protocol); it holds the engine until its token
        drains."""
        from strom_torch.delivery.stream import StreamingGather

        if self._closed:
            raise RuntimeError("StromContext is closed")
        return StreamingGather(self, self.resolve_source(source), segments,
                               dest, base_offset)

    def alloc_read_buffer(self, source: Source, nbytes: int) -> np.ndarray:
        """A fresh page-aligned host buffer for a gather from *source* that
        the caller drives itself (the streamed batch assembly), as ``pread``
        allocates its own. (The reference binds it to *source*'s NUMA node;
        the port binds none.)"""
        return alloc_aligned(nbytes)

    def pread(self, source: Source, offset: int = 0,
              length: int | None = None) -> np.ndarray:
        """Read bytes of *source* into a fresh aligned host buffer, with no
        device copy: the path format readers take for indexes, labels and
        members before decode."""
        if self._closed:
            raise RuntimeError("StromContext is closed")
        source = self.resolve_source(source)
        if length is None:
            length = source_size(source) - offset
        if length == 0:
            return np.empty(0, dtype=np.uint8)
        dest = alloc_aligned(length)
        self._read_segments(source, [Segment(0, 0, length)], dest, offset)
        return dest

    def memcpy_ssd2host(self, source: Source, *, offset: int = 0,
                        shape: Sequence[int] | None = None,
                        dtype: Any = np.uint8, length: int | None = None,
                        out: np.ndarray | None = None) -> np.ndarray:
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
        self._read_segments(source, [Segment(0, 0, nbytes)], dest, offset)
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
            with torch.cuda.stream(consumer):
                out = torch.empty(slab.shape, dtype=torch_dtype(slab.dtype),
                                  device=device)
            ev = self._copy_async(out, slab, self._copy_stream(device))
            consumer.wait_event(ev)
            ev.synchronize()   # the slab's last reader has retired
        finally:
            self._release(slab, True)
        return out

    def release_host_batch(self, host: np.ndarray,
                           device: torch.device) -> None:
        """Give back a :meth:`host_batch` array that was never put (its
        batch failed): only once nothing writes into it any more."""
        self._release(host, device.type == "cuda")

    def _deliver_streamed(self, source: Source, segments: Sequence[Segment],
                          base_offset: int, out: torch.Tensor) -> torch.Tensor:
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
                    self._read_segments(source, segs, slab, base_offset)
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
                       async_: bool = False) -> "torch.Tensor | DMAHandle":
        """Read bytes from *source* and deliver them as a torch.Tensor.

        - shape/dtype: array view of the bytes (row-major on disk); shape
          None → length bytes of uint8 (length None → to EOF).
        - device: the target; None → the current CUDA device (raises when
          there is none). ``device="cpu"`` returns a tensor aliasing the
          host slab.
        - async_: return a DMAHandle at once (≙ MEMCPY_SSD2GPU_ASYNC);
          otherwise the tensor (≙ MEMCPY_SSD2GPU). The tensor is ordered
          before any later work on the stream that was current at the call.
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
                    with torch.cuda.stream(consumer):
                        out = torch.empty(nbytes, dtype=torch.uint8,
                                          device=device)
                else:
                    out = torch.empty(nbytes, dtype=torch.uint8)
                out = self._deliver_streamed(source, segs, offset, out)
                if cuda:
                    consumer.wait_stream(self._copy_stream(device))
                return out.view(tdt).reshape(shape)
            slab = self._acquire(nbytes, cuda)
            try:
                self._read_segments(source, segs, slab, offset)
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

    # -- introspection and lifecycle -----------------------------------------
    def buffer_info(self) -> dict:
        """The engine's staging pool (≙ LIST/INFO_GPU_MEMORY)."""
        return self.engine.buffer_info()

    def stats(self) -> dict:
        with self._counts_lock:
            out = dict(self._counts)
        out["engine"] = self.engine.stats()
        if self._slab_pool is not None:
            out["slab_pool"] = self._slab_pool.stats()
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._executor.shutdown(wait=True)
        self.engine.close()
        if self._slab_pool is not None:
            self._slab_pool.close()

    def __enter__(self) -> "StromContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
