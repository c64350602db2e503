"""FIEMAP extent mapping — userspace equivalent of nvme-strom's in-kernel
extent resolver (the port's copy of ``strom/probe/fiemap.py``).

nvme-strom resolves file offset → NVMe LBA inside the kernel module using
ext4/xfs internals. A userspace engine does not need LBAs — io_uring and
O_DIRECT take (fd, file offset) — but the extent map is still load-bearing:
:func:`strom_torch.check_file` uses it to prove the file is fully mapped
and to report fragmentation, and the delivery layer's extent-aware planner
(``strom_torch.delivery.chunk_plan``) orders gathers by it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import os

# From <linux/fiemap.h>
FS_IOC_FIEMAP = 0xC020660B  # _IOWR('f', 11, struct fiemap) with 32-byte header

FIEMAP_FLAG_SYNC = 0x0001

FIEMAP_EXTENT_LAST = 0x0001
FIEMAP_EXTENT_UNKNOWN = 0x0002
FIEMAP_EXTENT_DELALLOC = 0x0004
FIEMAP_EXTENT_ENCODED = 0x0008
FIEMAP_EXTENT_UNWRITTEN = 0x0800
FIEMAP_EXTENT_MERGED = 0x1000
FIEMAP_EXTENT_SHARED = 0x2000


class _FiemapExtent(ctypes.Structure):
    _fields_ = [
        ("fe_logical", ctypes.c_uint64),
        ("fe_physical", ctypes.c_uint64),
        ("fe_length", ctypes.c_uint64),
        ("fe_reserved64", ctypes.c_uint64 * 2),
        ("fe_flags", ctypes.c_uint32),
        ("fe_reserved", ctypes.c_uint32 * 3),
    ]


def _fiemap_struct(n_extents: int):
    class _Fiemap(ctypes.Structure):
        _fields_ = [
            ("fm_start", ctypes.c_uint64),
            ("fm_length", ctypes.c_uint64),
            ("fm_flags", ctypes.c_uint32),
            ("fm_mapped_extents", ctypes.c_uint32),
            ("fm_extent_count", ctypes.c_uint32),
            ("fm_reserved", ctypes.c_uint32),
            ("fm_extents", _FiemapExtent * n_extents),
        ]

    return _Fiemap


@dataclasses.dataclass(frozen=True)
class Extent:
    logical: int    # byte offset in file
    physical: int   # byte offset on the backing block device
    length: int     # bytes
    flags: int

    @property
    def is_last(self) -> bool:
        return bool(self.flags & FIEMAP_EXTENT_LAST)

    @property
    def is_unwritten(self) -> bool:
        return bool(self.flags & FIEMAP_EXTENT_UNWRITTEN)

    @property
    def is_reliable(self) -> bool:
        """Physical offset can be trusted for locality reasoning."""
        return not (self.flags & (FIEMAP_EXTENT_UNKNOWN | FIEMAP_EXTENT_DELALLOC | FIEMAP_EXTENT_ENCODED))


def fiemap(path_or_fd: str | int, start: int = 0, length: int | None = None,
           sync: bool = True, batch: int = 256) -> list[Extent]:
    """Return the extent map of a file via the FIEMAP ioctl.

    Raises OSError if the filesystem does not support FIEMAP (e.g. tmpfs on
    old kernels); callers treat that as "extent map unavailable", not fatal.
    """
    own_fd = isinstance(path_or_fd, str)
    fd = os.open(path_or_fd, os.O_RDONLY) if own_fd else path_or_fd
    try:
        if length is None:
            length = max(os.fstat(fd).st_size - start, 0)
        extents: list[Extent] = []
        cursor = start
        end = start + length
        struct_cls = _fiemap_struct(batch)
        while cursor < end:
            fm = struct_cls()
            fm.fm_start = cursor
            fm.fm_length = end - cursor
            fm.fm_flags = FIEMAP_FLAG_SYNC if sync else 0
            fm.fm_extent_count = batch
            fcntl.ioctl(fd, FS_IOC_FIEMAP, fm)
            n = fm.fm_mapped_extents
            if n == 0:
                break
            done = False
            for i in range(n):
                e = fm.fm_extents[i]
                ext = Extent(e.fe_logical, e.fe_physical, e.fe_length, e.fe_flags)
                extents.append(ext)
                if ext.is_last:
                    done = True
            if done:
                break
            last = extents[-1]
            cursor = last.logical + last.length
        return extents
    finally:
        if own_fd:
            os.close(fd)


def fragmentation(extents: list[Extent]) -> tuple[int, int, float]:
    """(reliable extent count, mean extent bytes, physically-sequential
    fraction). The last is the fraction of inter-extent transitions whose
    physical placement continues where the previous extent ended — 1.0 means
    logical order IS physical order and extent-aware planning cannot help."""
    ext = sorted((e for e in extents if e.is_reliable and e.length > 0),
                 key=lambda e: e.logical)
    if not ext:
        return 0, 0, 1.0
    mean = sum(e.length for e in ext) // len(ext)
    if len(ext) == 1:
        return 1, mean, 1.0
    seq = sum(1 for a, b in zip(ext, ext[1:])
              if a.physical + a.length == b.physical)
    return len(ext), mean, seq / (len(ext) - 1)


def coverage(extents: list[Extent], file_size: int) -> float:
    """Fraction of [0, file_size) covered by mapped extents."""
    if file_size <= 0:
        return 1.0
    covered = 0
    for e in extents:
        lo = min(e.logical, file_size)
        hi = min(e.logical + e.length, file_size)
        covered += max(hi - lo, 0)
    return covered / file_size
