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

import contextlib
import mmap
from typing import Callable

import numpy as np
from strom_torch.utils.locks import make_lock

PAGE = mmap.PAGESIZE
_MAP_POPULATE = getattr(mmap, "MAP_POPULATE", 0x8000)
_MAP_HUGETLB = getattr(mmap, "MAP_HUGETLB", 0x40000)
HUGE_PAGE = 2 * 1024 * 1024
_HOST_REGISTER_PORTABLE = 1


def buf_addr(arr: np.ndarray) -> int:
    """Address of an array's first byte."""
    return arr.view(np.uint8).reshape(-1).__array_interface__["data"][0]


def alloc_aligned(nbytes: int, *, populate: bool = False,
                  huge: bool = False) -> np.ndarray:
    """A page-aligned uint8 slab of *nbytes* as a numpy array (an anonymous
    mmap that lives as long as the array). populate=True prefaults the
    pages inside the mmap call instead of during the read. huge=True tries
    MAP_HUGETLB (2 MiB pages) and takes normal pages where none are
    reserved."""
    if nbytes <= 0:
        raise ValueError("nbytes must be positive")
    flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
    if populate:
        flags |= _MAP_POPULATE
    if huge:
        hpadded = (nbytes + HUGE_PAGE - 1) // HUGE_PAGE * HUGE_PAGE
        try:
            mm = mmap.mmap(-1, hpadded, flags=flags | _MAP_HUGETLB)
            return np.frombuffer(mm, dtype=np.uint8)[:nbytes]
        except OSError:
            pass   # no huge pages reserved: normal pages below
    padded = (nbytes + PAGE - 1) // PAGE * PAGE
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
    Each slab is registered when it is made: with CUDA under ``pin=True``,
    then with ``on_alloc`` (the engine's ring registration). When it leaves
    the pool (past ``max_bytes`` cached, or at :meth:`close`) ``on_free``
    runs first and the CUDA registration goes second, so the ring never
    holds pages CUDA has released. The pool keeps every registered slab
    alive until then, and :meth:`close` unregisters every one of them,
    those still out included: no registered slab outlives the pool.

    The recycle contract: ``release()`` only once nothing reads or writes
    the slab — for delivery, after the device copy out of it has *retired*
    (its CUDA event completed), not when ``copy_()`` returns. A slab an
    engine may still write into (an abandoned piece) goes to :meth:`park`
    instead: never reused, kept registered until the pool closes.
    """

    def __init__(self, max_bytes: int = 512 * 1024 * 1024, *, pin: bool = False,
                 on_alloc: Callable[[np.ndarray], object] | None = None,
                 on_free: Callable[[np.ndarray], None] | None = None,
                 place: Callable[[np.ndarray], object] | None = None):
        self.max_bytes = max_bytes
        self.pin = pin
        # runs on a fresh slab before anything registers it (NUMA binding:
        # mbind cannot move pages that cudaHostRegister has pinned)
        self._place = place
        self._on_alloc = on_alloc
        self._on_free = on_free
        self._free: dict[int, list[np.ndarray]] = {}  # class size -> slabs
        self._registered: dict[int, np.ndarray] = {}  # addr -> slab
        # slabs an engine may still write into: out of use, never reused
        self._parked: list[np.ndarray] = []
        self._cached_bytes = 0
        self._lock = make_lock("slab.pool")
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.in_use_bytes = 0
        # change hooks (the scheduler's admission gate): run after every
        # acquire and release, so queued background admits re-check the
        # occupancy without polling
        self._change_hooks: list = []

    def add_change_hook(self, fn) -> None:
        """Register a no-argument callable run (outside the pool's lock)
        after every change of ``in_use_bytes``."""
        self._change_hooks.append(fn)

    def _occupancy_changed(self) -> None:
        from strom_torch.utils.stats import global_stats

        global_stats.set_gauge("slab_pool_bytes_in_use", self.in_use_bytes)
        for fn in self._change_hooks:
            # a failing hook must not fail the allocation it rides on; the
            # gate re-polls on a timeout anyway
            with contextlib.suppress(Exception):
                fn()

    @property
    def _registers(self) -> bool:
        return self.pin or self._on_alloc is not None \
            or self._on_free is not None or self._place is not None

    def _register(self, slab: np.ndarray) -> None:
        if self._place is not None:
            self._place(slab)
        if self.pin:
            host_register(slab)
        self._registered[buf_addr(slab)] = slab
        if self._on_alloc is not None:
            self._on_alloc(slab)

    def _unregister(self, slab: np.ndarray) -> None:
        if self._registered.pop(buf_addr(slab), None) is not None:
            if self._on_free is not None:
                self._on_free(slab)   # the ring lets go before CUDA does
            if self.pin:
                host_unregister(slab)

    def acquire(self, nbytes: int) -> np.ndarray:
        cls = size_class(nbytes)
        with self._lock:
            if self._closed:
                raise RuntimeError("SlabPool is closed")
            self.in_use_bytes += cls
            bucket = self._free.get(cls)
            slab = None
            if bucket:
                self.hits += 1
                self._cached_bytes -= cls
                slab = bucket.pop()[:nbytes]
            else:
                self.misses += 1
        self._occupancy_changed()
        if slab is not None:
            return slab
        try:
            slab = alloc_aligned(cls, populate=True)
            if self._registers:
                with self._lock:
                    self._register(slab)
        except BaseException:
            with self._lock:
                self.in_use_bytes -= cls
            self._occupancy_changed()
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
            elif self._registers:
                self._unregister(slab)
        self._occupancy_changed()

    def park(self, arr: np.ndarray) -> None:
        """Take back a slab that an engine may still write into (see
        ``strom_torch.engine.base.may_still_write``) without reusing it:
        it leaves ``in_use_bytes``, stays registered and referenced, and is
        unregistered only at :meth:`close`, which the owner calls after
        its engine has closed and joined its workers."""
        slab = _base(arr)
        with self._lock:
            self.in_use_bytes -= slab.nbytes
            self._parked.append(slab)
        self._occupancy_changed()

    def close(self) -> None:
        """Unregister every registered slab — cached, parked and still out
        — and drop the cached and parked ones. The owner calls it once no
        engine op and no copy can touch a slab any more; a slab still out
        then needs no unregistering when it comes back."""
        err: "BaseException | None" = None
        with self._lock:
            self._closed = True
            for slab in list(self._registered.values()):
                try:
                    self._unregister(slab)
                except BaseException as e:   # the rest still leave
                    err = err or e
            self._free.clear()
            self._parked.clear()
            self._cached_bytes = 0
        if err is not None:
            raise err

    def stats(self) -> dict:
        with self._lock:
            return {"cached_bytes": self._cached_bytes,
                    "slab_in_use_bytes": self.in_use_bytes,
                    "parked_bytes": sum(s.nbytes for s in self._parked),
                    "registered_slabs": len(self._registered),
                    "pinned_bytes": sum(s.nbytes for s in
                                        self._registered.values())
                    if self.pin else 0,
                    "hits": self.hits, "misses": self.misses}
