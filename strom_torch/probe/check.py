"""``strom_torch.check_file`` — userspace equivalent of STROM_IOCTL__CHECK_FILE
(the port's copy of ``strom/probe/check.py``).

nvme-strom's CHECK_FILE ioctl *refuses* files that can't take the direct
path (wrong fs, non-NVMe device). The port instead *tiers* every file: the
engine always works, but the report says which path the file will ride and
why, so callers (and tests) can assert the fast path is actually in play.
"""

from __future__ import annotations

import dataclasses
import enum
import os

from strom_torch.probe import fiemap as _fiemap
from strom_torch.probe.odirect import DioAlignment, probe_dio
from strom_torch.probe.topology import BlockDevice, device_for_file

# statfs f_type magics (linux/magic.h)
_FS_MAGICS = {
    0xEF53: "ext4",
    0x58465342: "xfs",
    0x9123683E: "btrfs",
    0x01021994: "tmpfs",
    0x6969: "nfs",
    0x794C7630: "overlayfs",
    0x2FC12FC1: "zfs",
    0xF2F52010: "f2fs",
}


class PathTier(enum.Enum):
    """Which data path the file will ride (fast → slow)."""

    DIRECT_NVME = "direct-nvme"    # O_DIRECT onto an NVMe (or raid0-of-NVMe) device
    DIRECT = "direct"              # O_DIRECT but device class unknown / not NVMe
    BUFFERED = "buffered"          # page-cache reads (≙ reference's cached-page fallback)


@dataclasses.dataclass(frozen=True)
class FileReport:
    path: str
    size: int
    fs_type: str
    tier: PathTier
    dio: DioAlignment
    device: BlockDevice | None
    extents: int                  # number of mapped extents (0 = map unavailable)
    extent_coverage: float        # fraction of file covered by reliable extents
    reasons: tuple[str, ...]      # human-readable: why this tier
    fragmented: bool = False      # >1 reliable extent with non-sequential placement
    mean_extent_bytes: int = 0    # mean reliable extent length (0 = map unavailable)
    # fraction of the file currently page-cache resident (None: unprobeable):
    # the residency hybrid serves this fraction as memcpys instead of media
    # reads (strom_torch/probe/residency.py)
    cached_frac: float | None = None

    @property
    def supported(self) -> bool:
        """Parity with the reference's boolean CHECK_FILE verdict: True when the
        direct path is available."""
        return self.tier in (PathTier.DIRECT_NVME, PathTier.DIRECT)


def check_file(path, *, want_extents: bool = True) -> FileReport:
    """Tier *path*. Also accepts a striped set (any object with ``members``
    and ``chunk`` — e.g. ``strom_torch.StripedFile``; duck-typed so the probe
    layer needs no delivery import): every member is checked and the set
    reports the WORST member tier, mirroring the reference's CHECK_FILE
    rule that an md-raid0 file is fast-path only when every member device
    is NVMe."""
    if hasattr(path, "members") and hasattr(path, "chunk"):
        return _check_striped(path, want_extents=want_extents)
    st = os.stat(path)
    fs_type = _fs_type(path)
    reasons: list[str] = []

    dio = probe_dio(path)
    device = None
    try:
        device = device_for_file(path)
    except OSError:
        pass

    extents = 0
    cov = 0.0
    fragmented = False
    mean_extent = 0
    if want_extents and st.st_size > 0:
        try:
            ext = _fiemap.fiemap(path)
            extents = len(ext)
            cov = _fiemap.coverage([e for e in ext if e.is_reliable], st.st_size)
            n_rel, mean_extent, seq_frac = _fiemap.fragmentation(ext)
            # chunking advice: a logically-sequential read of a physically
            # scattered file reaches the device as random LBA hops; the
            # delivery layer's extent-aware planner reorders to fix that
            # (strom_torch.delivery.chunk_plan, on by default)
            fragmented = n_rel > 1 and seq_frac < 1.0
            if fragmented:
                reasons.append(
                    f"fragmented: {n_rel} extents, mean "
                    f"{mean_extent >> 10} KiB, {seq_frac:.0%} physically "
                    "sequential; extent-aware gather planning will reorder "
                    "reads into physical-address order")
        except OSError:
            reasons.append("fiemap unavailable on this filesystem")

    cached_frac = None
    if st.st_size > 0:
        from strom_torch.probe.residency import cached_pages

        r = None
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            pass  # stat-able but unreadable (EACCES): degrade like every
            # other probe here — check_file reports, it never raises
        else:
            try:
                r = cached_pages(fd, 0, st.st_size)
            finally:
                os.close(fd)
        if r is not None and r[1]:
            cached_frac = r[0] / r[1]
            if cached_frac > 0:
                reasons.append(
                    f"{cached_frac:.0%} page-cache resident: the residency "
                    "hybrid serves warm ranges as memcpys")

    if not dio.supported:
        tier = PathTier.BUFFERED
        reasons.append(f"O_DIRECT unsupported (source={dio.source}); buffered fallback")
    else:
        if device is not None and device.fast_class in ("nvme", "raid0-nvme"):
            tier = PathTier.DIRECT_NVME
            reasons.append(f"O_DIRECT on {device.fast_class} device {device.name}")
        else:
            tier = PathTier.DIRECT
            dev = device.name if device else "unresolvable"
            reasons.append(f"O_DIRECT supported; device {dev} not identified as NVMe")

    return FileReport(
        path=os.path.abspath(path),
        size=st.st_size,
        fs_type=fs_type,
        tier=tier,
        dio=dio,
        device=device,
        extents=extents,
        extent_coverage=cov,
        reasons=tuple(reasons),
        fragmented=fragmented,
        mean_extent_bytes=mean_extent,
        cached_frac=cached_frac,
    )


# fast -> slow; a striped set rides the tier of its SLOWEST member
_TIER_RANK = {PathTier.DIRECT_NVME: 2, PathTier.DIRECT: 1, PathTier.BUFFERED: 0}


def _check_striped(sf, *, want_extents: bool = True) -> FileReport:
    reports = [check_file(m, want_extents=want_extents) for m in sf.members]
    worst = min(reports, key=lambda r: _TIER_RANK[r.tier])
    reasons = [
        f"raid0 set: {len(sf.members)} members, chunk {sf.chunk >> 10} KiB; "
        f"set tier = worst member tier ({worst.tier.value})"
    ]
    if all(r.tier is PathTier.DIRECT_NVME for r in reports):
        reasons.append("all members on NVMe-class devices "
                       "(≙ reference's md-raid0-of-NVMe requirement)")
    for r in reports:
        if r.tier is not PathTier.DIRECT_NVME:
            reasons.append(f"member {r.path}: {r.tier.value} ({r.reasons[-1]})")
    mixed_fs = {r.fs_type for r in reports}
    total = sum(r.size for r in reports)
    probed_bytes = sum(r.size for r in reports if r.cached_frac is not None)
    # count-weighted: the mean over ALL the set's extents, so one heavily-
    # fragmented member isn't averaged away by a large contiguous one
    n_ext = sum(r.extents for r in reports if r.mean_extent_bytes)
    mean_extent = int(sum(r.mean_extent_bytes * r.extents
                          for r in reports) / n_ext) if n_ext else 0
    return FileReport(
        path="+".join(os.path.abspath(m) for m in sf.members),
        size=sf.size,
        fs_type=next(iter(mixed_fs)) if len(mixed_fs) == 1
        else "mixed(" + ",".join(sorted(mixed_fs)) + ")",
        tier=worst.tier,
        dio=worst.dio,
        device=None,  # one report spans N devices; per-member in reasons
        extents=sum(r.extents for r in reports),
        extent_coverage=(sum(r.extent_coverage * r.size for r in reports)
                         / total) if total else 0.0,
        reasons=tuple(reasons),
        fragmented=any(r.fragmented for r in reports),
        mean_extent_bytes=mean_extent,
        # byte-weighted over probeable members ONLY (a member whose probe
        # failed must not dilute the denominator); None when none probed
        cached_frac=(
            sum(r.cached_frac * r.size for r in reports
                if r.cached_frac is not None)
            / probed_bytes if probed_bytes else None),
    )


def _fs_type(path: str) -> str:
    import ctypes

    class _StatFs(ctypes.Structure):
        _fields_ = [
            ("f_type", ctypes.c_long),
            ("f_bsize", ctypes.c_long),
            ("f_blocks", ctypes.c_ulong),
            ("f_bfree", ctypes.c_ulong),
            ("f_bavail", ctypes.c_ulong),
            ("f_files", ctypes.c_ulong),
            ("f_ffree", ctypes.c_ulong),
            ("f_fsid", ctypes.c_long * 2),
            ("f_namelen", ctypes.c_long),
            ("f_frsize", ctypes.c_long),
            ("f_flags", ctypes.c_long),
            ("f_spare", ctypes.c_long * 4),
        ]

    libc = ctypes.CDLL(None, use_errno=True)
    buf = _StatFs()
    rc = libc.statfs(os.fsencode(path), ctypes.byref(buf))
    if rc != 0:
        return "unknown"
    return _FS_MAGICS.get(buf.f_type & 0xFFFFFFFF, f"0x{buf.f_type & 0xFFFFFFFF:X}")
