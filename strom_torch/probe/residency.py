"""Per-range page-cache residency probing (the port's copy of
``strom/probe/residency.py``).

nvme-strom's hybrid submit checks per-block page-cache residency and
memcpy-serves warm blocks instead of re-reading them from flash. This
module is the userspace probe the preadv pool, ``check_file`` and the
tests use: ``cachestat(2)`` on kernels >= 6.5, else
``mincore(2)`` on a transient buffered mapping.  Neither probe populates the
page cache, so probing a cold file leaves it cold.

The C++ engine carries its own copy of this logic (strom_core.cpp
``resident_pages``) so the native hot loop never crosses back into Python.
"""

from __future__ import annotations

import ctypes
import errno
import mmap
import os

_NR_CACHESTAT = 451  # same number on every 64-bit Linux arch (6.5+)


class _CachestatRange(ctypes.Structure):
    _fields_ = [("off", ctypes.c_uint64), ("len", ctypes.c_uint64)]


class _Cachestat(ctypes.Structure):
    _fields_ = [
        ("nr_cache", ctypes.c_uint64),
        ("nr_dirty", ctypes.c_uint64),
        ("nr_writeback", ctypes.c_uint64),
        ("nr_evicted", ctypes.c_uint64),
        ("nr_recently_evicted", ctypes.c_uint64),
    ]


_libc = ctypes.CDLL(None, use_errno=True)
# 0 = untried, 1 = cachestat, 2 = mincore (cachestat ENOSYS)
_probe_state = 0


def cached_pages(fd: int, offset: int, length: int) -> tuple[int, int] | None:
    """(resident_pages, covering_pages) for file byte range [offset,
    offset+length) on buffered *fd*, or None when unprobeable."""
    global _probe_state
    ps = mmap.PAGESIZE
    start = offset // ps * ps
    end = (offset + length + ps - 1) // ps * ps
    npages = (end - start) // ps
    if npages == 0:
        return (0, 0)
    if _probe_state <= 1:
        r = _CachestatRange(offset, length)
        cs = _Cachestat()
        err = 0
        for _ in range(3):  # EINTR/EAGAIN are retryable, not a verdict on
            ctypes.set_errno(0)  # whether the syscall exists
            rc = _libc.syscall(_NR_CACHESTAT, fd, ctypes.byref(r),
                               ctypes.byref(cs), 0)
            if rc == 0:
                _probe_state = 1
                return (int(cs.nr_cache), npages)
            err = ctypes.get_errno()
            if err not in (errno.EINTR, errno.EAGAIN):
                break
        if _probe_state == 1:
            return None  # transient failure on a probe that was working
        if err in (errno.ENOSYS, errno.EPERM):
            # the syscall genuinely isn't available (pre-6.5 kernel, or a
            # seccomp profile denying unknown syscalls): demote permanently
            # to mincore, which exists everywhere
            _probe_state = 2
        # any other first-call failure: fall through to mincore for THIS
        # call but leave the state untried so cachestat gets another chance
    # mincore fallback on transient mappings via raw libc (the fd is
    # O_RDONLY, so the mapping is PROT_READ and ctypes' from_buffer refuses
    # it — we need the raw address anyway); mincore never faults pages in.
    # Probed in bounded windows so a whole-file probe of a TB-scale shard
    # stays O(window) in memory (vector is 1 byte/page), not O(file).
    import numpy as np

    _libc.mmap.restype = ctypes.c_void_p
    window = 1 << 30
    resident = 0
    pos = start
    while pos < end:
        sz = min(window, end - pos)
        wpages = (sz + ps - 1) // ps
        addr = _libc.mmap(None, ctypes.c_size_t(sz), mmap.PROT_READ,
                          mmap.MAP_SHARED, fd, ctypes.c_long(pos))
        if addr is None or addr == ctypes.c_void_p(-1).value:
            return None
        try:
            vec = (ctypes.c_ubyte * wpages)()
            rc = _libc.mincore(ctypes.c_void_p(addr), ctypes.c_size_t(sz),
                               vec)
            if rc != 0:
                return None
            resident += int((np.frombuffer(vec, dtype=np.uint8) & 1).sum())
        finally:
            _libc.munmap(ctypes.c_void_p(addr), ctypes.c_size_t(sz))
        pos += sz
    return (resident, npages)


def range_fully_cached(fd: int, offset: int, length: int) -> bool | None:
    """True if every page covering the range is resident; None = unprobeable."""
    r = cached_pages(fd, offset, length)
    if r is None:
        return None
    resident, total = r
    return resident >= total


def drop_cache(path: str) -> None:
    """Best-effort eviction of *path*'s clean pages (fsync + FADV_DONTNEED).
    Test/bench helper for forcing the cold path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
