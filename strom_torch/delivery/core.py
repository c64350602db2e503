"""memcpy_ssd2gpu — the hot path (the port's counterpart of
``StromContext.memcpy_ssd2tpu`` in ``strom/delivery/core.py``).

Read a file range (or an ExtentList) with the engine, O_DIRECT where the
file allows, into a page-aligned pinned host slab; copy the slab into a
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
import errno
import math
import os
import queue
import threading
from typing import Any, Sequence

import numpy as np
import torch

from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import SlabPool, alloc_aligned
from strom_torch.delivery.coalesce import coalesce_chunks, coalesce_segments
from strom_torch.delivery.extents import ExtentList
from strom_torch.delivery.handle import DMAHandle, deferred_handle
from strom_torch.delivery.shard import Segment
from strom_torch.engine import make_engine
from strom_torch.engine.base import Engine, EngineError

# anything memcpy_ssd2gpu can read from
Source = str | ExtentList


def source_size(source: Source) -> int:
    return source.size if isinstance(source, ExtentList) \
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


class StromContext:
    """Owns the engine, the file registrations, the pinned slab pool, the
    per-device copy streams and the executor of async transfers."""

    def __init__(self, config: StromConfig | None = None,
                 engine: Engine | None = None):
        self.config = config or StromConfig.from_env()
        self.engine = engine or make_engine(self.config)
        self._files: dict[str, int] = {}
        self._files_lock = threading.Lock()
        # one gather at a time on the engine: concurrent transfers must not
        # interleave queue-depth budgets
        self._engine_lock = threading.Lock()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.config.delivery_workers),
            thread_name_prefix="strom-delivery")
        # slabs are pinned on first use, which needs CUDA: the pool serves
        # CUDA targets only
        self._slab_pool = SlabPool(self.config.slab_pool_bytes, pin=True) \
            if self.config.slab_pool_bytes > 0 else None
        self._copy_streams: dict[torch.device, torch.cuda.Stream] = {}
        self._counts = collections.Counter(
            {"ssd2gpu_bytes": 0, "transfers": 0, "streamed_transfers": 0})
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

    def _count(self, **kv: int) -> None:
        with self._counts_lock:
            self._counts.update(kv)

    # -- planning and the engine gather -------------------------------------
    def _plan_chunks(self, source: Source, segments: Sequence[Segment],
                     base_offset: int = 0) -> list[tuple[int, int, int, int]]:
        """Logical (file_offset+base_offset → dest_offset) segments →
        physical (file_index, file_offset, dest_offset, length) engine ops,
        coalesced where contiguous in both file and dest space."""
        cmax = self.config.coalesce_max_bytes
        if cmax and len(segments) > 1:
            segments = coalesce_segments(segments, cmax)
        if isinstance(source, ExtentList):
            chunks = [(self.file_index(r.path), r.offset, r.dest_offset, r.length)
                      for seg in segments
                      for r in source.locate(base_offset + seg.file_offset,
                                             seg.length, seg.dest_offset)]
        else:
            fi = self.file_index(source)
            chunks = [(fi, base_offset + s.file_offset, s.dest_offset, s.length)
                      for s in segments]
        if cmax and len(chunks) > 1:
            chunks = coalesce_chunks(chunks, cmax)
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
            if not cuda:
                self._read_segments(source, segs, slab, offset)
                return torch.from_numpy(slab.view(np_dtype).reshape(shape))
            try:
                self._read_segments(source, segs, slab, offset)
                with torch.cuda.stream(consumer):
                    out = torch.empty(nbytes, dtype=torch.uint8, device=device)
                ev = self._copy_async(out, slab, self._copy_stream(device))
                consumer.wait_event(ev)
                ev.synchronize()   # the slab's last reader has retired
            finally:
                self._release(slab, cuda)
            return out.view(tdt).reshape(shape)

        if async_:
            return deferred_handle(run, self._executor, nbytes,
                                   f"{source!r}@{offset}")
        return run()

    # -- lifecycle -----------------------------------------------------------
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
