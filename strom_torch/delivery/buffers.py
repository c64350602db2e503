"""Page-aligned, pinned host slabs (the port's counterpart of
``strom/delivery/buffers.py``).

A slab is where the NVMe reads land *and* what the host→device copy reads
from: one landing spot, no bounce copy. On a CUDA target every pool slab is
page-locked and registered with the CUDA driver (``cudaHostRegister``
through ``torch.cuda.cudart()``), so ``copy_(..., non_blocking=True)`` out
of it is a DMA the copy engine runs while the next read proceeds.
Registration leaves the pages where they are, so the slab keeps its page
alignment and O_DIRECT still reads straight into it.

A slab stays an anonymous ``mmap``: io_uring may refuse to register memory
that CUDA's own host allocator mapped (``pin_memory=True``), and the
delivery layer registers every pool slab with the engine's ring as well
(``on_alloc``/``on_free``), so gathers into it ride ``READ_FIXED``.
"""

from __future__ import annotations

import mmap
import threading
from typing import Callable

import numpy as np

PAGE = mmap.PAGESIZE
_MAP_POPULATE = getattr(mmap, "MAP_POPULATE", 0x8000)
_HOST_REGISTER_PORTABLE = 1


def buf_addr(arr: np.ndarray) -> int:
    """Address of an array's first byte."""
    return arr.view(np.uint8).reshape(-1).__array_interface__["data"][0]


def alloc_aligned(nbytes: int, *, populate: bool = False) -> np.ndarray:
    """A page-aligned uint8 slab of *nbytes* as a numpy array (an anonymous
    mmap that lives as long as the array). populate=True prefaults the
    pages inside the mmap call instead of during the read."""
    if nbytes <= 0:
        raise ValueError("nbytes must be positive")
    padded = (nbytes + PAGE - 1) // PAGE * PAGE
    flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
    if populate:
        flags |= _MAP_POPULATE
    mm = mmap.mmap(-1, padded, flags=flags)
    return np.frombuffer(mm, dtype=np.uint8)[:nbytes]


def host_register(arr: np.ndarray) -> None:
    """Page-lock *arr*'s pages and register them with CUDA
    (``cudaHostRegister``), so copies into or out of it are DMAs."""
    import torch

    rc = int(torch.cuda.cudart().cudaHostRegister(
        buf_addr(arr), arr.nbytes, _HOST_REGISTER_PORTABLE))
    if rc != 0:
        raise RuntimeError(f"cudaHostRegister of a {arr.nbytes}-byte "
                           f"buffer failed (cudaError {rc})")


def host_unregister(arr: np.ndarray) -> None:
    import torch

    rc = int(torch.cuda.cudart().cudaHostUnregister(buf_addr(arr)))
    if rc != 0:
        raise RuntimeError(f"cudaHostUnregister failed (cudaError {rc})")


def size_class(nbytes: int) -> int:
    """Round a request up to its allocation size class: quarter-power-of-two
    steps (4KiB, ..., 1MiB, 1.25MiB, 1.5MiB, ...), worst-case waste 25%,
    every class a page multiple."""
    n = max(int(nbytes), PAGE)
    p = 1 << (n.bit_length() - 1)          # largest pow2 <= n
    step = max(p // 4, PAGE)
    return (n + step - 1) // step * step


def _base(arr: np.ndarray) -> np.ndarray:
    while isinstance(arr.base, np.ndarray):
        arr = arr.base
    return arr


class SlabPool:
    """Recycles aligned slabs so steady-state transfers fault no pages.

    Slabs are allocated at size-class granularity; acquire() hands out a
    view of the first ``nbytes``; release() walks the view back to its slab.
    With ``pin=True`` each slab is registered with CUDA when it is made, then
    handed to ``on_alloc`` (the engine's ring registration); when it leaves
    the pool (past ``max_bytes`` cached, or at :meth:`close`) ``on_free``
    runs first and the CUDA registration goes second, so the ring never
    holds pages CUDA has released. The pool keeps every registered slab
    alive until then.

    The recycle contract: ``release()`` only once nothing reads the slab —
    for delivery, after the device copy out of it has *retired* (its CUDA
    event completed), not when ``copy_()`` returns.
    """

    def __init__(self, max_bytes: int = 512 * 1024 * 1024, *, pin: bool = False,
                 on_alloc: Callable[[np.ndarray], object] | None = None,
                 on_free: Callable[[np.ndarray], None] | None = None):
        self.max_bytes = max_bytes
        self.pin = pin
        self._on_alloc = on_alloc
        self._on_free = on_free
        self._free: dict[int, list[np.ndarray]] = {}  # class size -> slabs
        self._registered: dict[int, np.ndarray] = {}  # addr -> slab
        self._cached_bytes = 0
        self._lock = threading.Lock()
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.in_use_bytes = 0

    def _register(self, slab: np.ndarray) -> None:
        host_register(slab)
        self._registered[buf_addr(slab)] = slab
        if self._on_alloc is not None:
            self._on_alloc(slab)

    def _unregister(self, slab: np.ndarray) -> None:
        if self._registered.pop(buf_addr(slab), None) is not None:
            if self._on_free is not None:
                self._on_free(slab)   # the ring lets go before CUDA does
            host_unregister(slab)

    def acquire(self, nbytes: int) -> np.ndarray:
        cls = size_class(nbytes)
        with self._lock:
            if self._closed:
                raise RuntimeError("SlabPool is closed")
            self.in_use_bytes += cls
            bucket = self._free.get(cls)
            if bucket:
                self.hits += 1
                self._cached_bytes -= cls
                return bucket.pop()[:nbytes]
            self.misses += 1
        try:
            slab = alloc_aligned(cls, populate=True)
            if self.pin:
                with self._lock:
                    self._register(slab)
        except BaseException:
            with self._lock:
                self.in_use_bytes -= cls
            raise
        return slab[:nbytes]

    def release(self, arr: np.ndarray) -> None:
        slab = _base(arr)
        cls = slab.nbytes
        with self._lock:
            self.in_use_bytes -= cls
            if not self._closed and self._cached_bytes + cls <= self.max_bytes:
                self._free.setdefault(cls, []).append(slab)
                self._cached_bytes += cls
            elif self.pin:
                self._unregister(slab)

    def close(self) -> None:
        """Unregister and drop every cached slab; slabs still out are
        unregistered when they come back."""
        with self._lock:
            self._closed = True
            for bucket in self._free.values():
                for slab in bucket:
                    if self.pin:
                        self._unregister(slab)
            self._free.clear()
            self._cached_bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"cached_bytes": self._cached_bytes,
                    "slab_in_use_bytes": self.in_use_bytes,
                    "pinned_bytes": sum(s.nbytes for s in
                                        self._registered.values()),
                    "hits": self.hits, "misses": self.misses}
