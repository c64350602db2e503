"""O_DIRECT capability + alignment probing (the port's copy of
``strom/probe/odirect.py``).

nvme-strom's CHECK_FILE handler verifies in the kernel that the file's
filesystem and block device satisfy its direct-DMA constraints. The
userspace equivalent: ask the kernel via statx(STATX_DIOALIGN) and, failing
that, attempt an aligned O_DIRECT read.
"""

from __future__ import annotations

import ctypes
import dataclasses
import errno
import mmap
import os

_SYS_statx = 332  # x86_64
_AT_FDCWD = -100
_STATX_DIOALIGN = 0x2000


class _StatxTimestamp(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_int64), ("tv_nsec", ctypes.c_uint32), ("__pad", ctypes.c_int32)]


class _Statx(ctypes.Structure):
    _fields_ = [
        ("stx_mask", ctypes.c_uint32),
        ("stx_blksize", ctypes.c_uint32),
        ("stx_attributes", ctypes.c_uint64),
        ("stx_nlink", ctypes.c_uint32),
        ("stx_uid", ctypes.c_uint32),
        ("stx_gid", ctypes.c_uint32),
        ("stx_mode", ctypes.c_uint16),
        ("__spare0", ctypes.c_uint16),
        ("stx_ino", ctypes.c_uint64),
        ("stx_size", ctypes.c_uint64),
        ("stx_blocks", ctypes.c_uint64),
        ("stx_attributes_mask", ctypes.c_uint64),
        ("stx_atime", _StatxTimestamp),
        ("stx_btime", _StatxTimestamp),
        ("stx_ctime", _StatxTimestamp),
        ("stx_mtime", _StatxTimestamp),
        ("stx_rdev_major", ctypes.c_uint32),
        ("stx_rdev_minor", ctypes.c_uint32),
        ("stx_dev_major", ctypes.c_uint32),
        ("stx_dev_minor", ctypes.c_uint32),
        ("stx_mnt_id", ctypes.c_uint64),
        ("stx_dio_mem_align", ctypes.c_uint32),
        ("stx_dio_offset_align", ctypes.c_uint32),
        ("__spare3", ctypes.c_uint64 * 12),
    ]


_libc = ctypes.CDLL(None, use_errno=True)


@dataclasses.dataclass(frozen=True)
class DioAlignment:
    supported: bool
    mem_align: int      # required userspace buffer alignment
    offset_align: int   # required file offset / length alignment
    source: str         # "statx" | "probe" | "unsupported"


def _statx_dioalign(path: str) -> DioAlignment | None:
    buf = _Statx()
    rc = _libc.syscall(ctypes.c_long(_SYS_statx), ctypes.c_int(_AT_FDCWD),
                       ctypes.c_char_p(os.fsencode(path)), ctypes.c_int(0),
                       ctypes.c_uint(_STATX_DIOALIGN), ctypes.byref(buf))
    if rc != 0:
        return None
    if not (buf.stx_mask & _STATX_DIOALIGN):
        return None
    if buf.stx_dio_mem_align == 0 or buf.stx_dio_offset_align == 0:
        # Kernel reports DIO not supported on this file.
        return DioAlignment(False, 0, 0, "statx")
    return DioAlignment(True, buf.stx_dio_mem_align, buf.stx_dio_offset_align, "statx")


def _empirical_probe(path: str) -> DioAlignment:
    """Open with O_DIRECT and attempt a 4KiB-aligned read."""
    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    except OSError as e:
        if e.errno in (errno.EINVAL, errno.ENOTSUP, errno.EOPNOTSUPP):
            return DioAlignment(False, 0, 0, "probe")
        raise
    try:
        size = os.fstat(fd).st_size
        if size >= 4096:
            buf = mmap.mmap(-1, 4096)  # page-aligned anonymous mapping
            try:
                os.preadv(fd, [memoryview(buf)], 0)
            except OSError:
                return DioAlignment(False, 0, 0, "probe")
            finally:
                buf.close()
        return DioAlignment(True, 4096, 4096, "probe")
    finally:
        os.close(fd)


def probe_dio(path: str) -> DioAlignment:
    """Determine whether *path* supports O_DIRECT and at what alignment."""
    st = _statx_dioalign(path)
    if st is not None:
        return st
    try:
        return _empirical_probe(path)
    except OSError:
        return DioAlignment(False, 0, 0, "unsupported")
