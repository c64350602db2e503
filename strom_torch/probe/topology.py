"""Block-device topology from sysfs (the port's copy of
``strom/probe/topology.py``).

nvme-strom verifies in the kernel that a file's backing device is an NVMe
namespace, or an md-raid0 array whose members are all NVMe. The userspace
equivalent: resolve st_dev → /sys/dev/block, walk partition →
parent, and classify; for md arrays read level/chunk/members from
``/sys/block/mdX/md``.
"""

from __future__ import annotations

import dataclasses
import os
import re

_SYSFS = "/sys"


@dataclasses.dataclass(frozen=True)
class BlockDevice:
    name: str                      # e.g. "nvme0n1", "md0", "vda"
    major: int
    minor: int
    is_nvme: bool
    is_rotational: bool | None
    logical_block_size: int | None
    queue_depth: int | None
    max_sectors_kb: int | None
    raid_level: str | None = None          # e.g. "raid0" for md arrays
    raid_chunk_bytes: int | None = None
    raid_members: tuple[str, ...] = ()
    numa_node: int | None = None           # home NUMA node (None = unknown/UMA)

    @property
    def is_raid0_of_nvme(self) -> bool:
        return self.raid_level == "raid0" and bool(self.raid_members) and all(
            m.startswith("nvme") for m in self.raid_members
        )

    @property
    def fast_class(self) -> str:
        """"nvme" | "raid0-nvme" | "ssd" | "hdd" | "unknown"."""
        if self.is_nvme:
            return "nvme"
        if self.is_raid0_of_nvme:
            return "raid0-nvme"
        if self.is_rotational is False:
            return "ssd"
        if self.is_rotational:
            return "hdd"
        return "unknown"


def _read_int(path: str) -> int | None:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _read_str(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def _parent_disk(sys_block_path: str) -> str:
    """Given /sys/dev/block/M:m (which may be a partition), return the whole-disk
    sysfs node path."""
    real = os.path.realpath(sys_block_path)
    if os.path.exists(os.path.join(real, "partition")):
        return os.path.dirname(real)
    return real


def _describe_disk(real: str) -> BlockDevice:
    name = os.path.basename(real)
    dev = _read_str(os.path.join(real, "dev")) or "0:0"
    major, minor = (int(x) for x in dev.split(":"))
    queue = os.path.join(real, "queue")
    is_nvme = bool(re.match(r"nvme\d+", name))
    rot = _read_int(os.path.join(queue, "rotational"))
    raid_level = _read_str(os.path.join(real, "md", "level"))
    raid_chunk = _read_int(os.path.join(real, "md", "chunk_size"))
    members: tuple[str, ...] = ()
    md_dir = os.path.join(real, "md")
    if os.path.isdir(md_dir):
        ms = []
        for entry in sorted(os.listdir(md_dir)):
            if entry.startswith("rd"):
                block_link = os.path.join(md_dir, entry, "block")
                if os.path.exists(block_link):
                    ms.append(os.path.basename(os.path.realpath(block_link)))
        members = tuple(ms)
    # the device's home NUMA node: <disk>/device/numa_node for virtio/scsi,
    # one level deeper for NVMe namespaces (disk -> ctrl -> PCI function)
    numa = _read_int(os.path.join(real, "device", "numa_node"))
    if numa is None:
        numa = _read_int(os.path.join(real, "device", "device", "numa_node"))
    if numa is not None and numa < 0:  # kernel reports -1 on UMA boxes
        numa = None
    return BlockDevice(
        name=name,
        major=major,
        minor=minor,
        is_nvme=is_nvme,
        is_rotational=None if rot is None else bool(rot),
        logical_block_size=_read_int(os.path.join(queue, "logical_block_size")),
        queue_depth=_read_int(os.path.join(queue, "nr_requests")),
        max_sectors_kb=_read_int(os.path.join(queue, "max_sectors_kb")),
        raid_level=raid_level,
        raid_chunk_bytes=raid_chunk,
        raid_members=members,
        numa_node=numa,
    )


def device_for_file(path: str, sysfs: str = _SYSFS) -> BlockDevice | None:
    """Classify the block device backing *path* (None if not resolvable,
    e.g. tmpfs/overlayfs with anonymous devices)."""
    st = os.stat(path)
    major, minor = os.major(st.st_dev), os.minor(st.st_dev)
    if major == 0:  # virtual filesystems
        return None
    node = os.path.join(sysfs, "dev", "block", f"{major}:{minor}")
    if not os.path.exists(node):
        return None
    return _describe_disk(_parent_disk(node))


def list_nvme_devices(sysfs: str = _SYSFS) -> list[BlockDevice]:
    out = []
    block_dir = os.path.join(sysfs, "block")
    try:
        names = sorted(os.listdir(block_dir))
    except OSError:
        return out
    for name in names:
        if re.match(r"nvme\d+n\d+$", name):
            out.append(_describe_disk(os.path.join(block_dir, name)))
    return out
