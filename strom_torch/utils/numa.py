"""NUMA / IRQ affinity for the submit path (the port's copy of
``strom/utils/numa.py``).

On a multi-socket host, NVMe DMA lands in the memory attached to the device's
PCIe root complex; if the staging slabs live on the other socket every read
crosses the inter-socket link twice (the DMA write, then the copy to the
card). An in-kernel data path inherits correct placement from blk-mq's
per-CPU queues; a userspace engine must opt in:

- pin the submitting thread to the device's home node's CPUs
  (``sched_setaffinity``) — also makes first-touch page faults land local,
- ``mbind``+move the already-faulted slab pages to that node (before they
  are pinned: ``cudaHostRegister``'d pages cannot move),
- (optionally, needs root) steer the device's IRQs to the same node.

Everything here is best-effort: on UMA boxes, denied syscalls, or unknown
topology each call is a no-op returning False. All knobs are off by default
(``StromConfig.numa_affinity``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import platform
import re
import threading

import numpy as np

_libc = ctypes.CDLL(None, use_errno=True)

# __NR_mbind — mbind(2) has no glibc wrapper outside libnuma
_NR_MBIND = {"x86_64": 237, "aarch64": 235}.get(platform.machine())

_MPOL_BIND = 2
_MPOL_MF_MOVE = 1 << 1


def node_cpus(node: int) -> set[int]:
    """CPUs of a NUMA node, from /sys/devices/system/node/nodeN/cpulist."""
    try:
        with open(f"/sys/devices/system/node/node{node}/cpulist") as f:
            text = f.read().strip()
    except OSError:
        return set()
    cpus: set[int] = set()
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            cpus.update(range(int(lo), int(hi) + 1))
        elif part:
            cpus.add(int(part))
    return cpus


def pin_current_thread(node: int) -> bool:
    """Restrict the calling thread to *node*'s CPUs. False if unknown node."""
    cpus = node_cpus(node)
    if not cpus:
        return False
    try:
        os.sched_setaffinity(0, cpus)  # tid 0 = calling thread
        return True
    except OSError:
        return False


def mbind_array(arr: np.ndarray, node: int) -> bool:
    """Bind (and migrate) the pages backing *arr* to *node*. Page-aligns the
    range inward; best-effort False on unsupported arch/denied syscall."""
    if _NR_MBIND is None:
        return False
    addr = arr.__array_interface__["data"][0]
    length = arr.nbytes
    page = os.sysconf("SC_PAGESIZE")
    aligned = addr & ~(page - 1)
    length += addr - aligned
    if length <= 0:
        return False
    # nodemask: one bit per node, single ulong is plenty (<=64 nodes)
    mask = ctypes.c_ulong(1 << node)
    rc = _libc.syscall(
        ctypes.c_long(_NR_MBIND), ctypes.c_void_p(aligned),
        ctypes.c_ulong(length), ctypes.c_int(_MPOL_BIND),
        ctypes.byref(mask), ctypes.c_ulong(64),
        ctypes.c_uint(_MPOL_MF_MOVE))
    return rc == 0


def _irq_candidates(device_name: str, parent_name: str | None = None
                    ) -> set[str]:
    """Regexes for the names a block device's IRQs carry in /proc/interrupts.
    The namespace name itself never appears there: NVMe queue IRQs are named
    nvme0q0, nvme0q1, ... (not nvme0n1) and virtio disks virtio0-requests
    (not vda) — match the controller, not the namespace. Both-sided word
    boundaries so nvme1 never prefix-matches nvme10's IRQs."""
    pats = {rf"\b{re.escape(device_name)}\b"}
    m = re.match(r"(nvme\d+)n\d+$", device_name)
    if m:
        pats.add(rf"\b{re.escape(m.group(1))}q\d+\b")
    if parent_name:
        pats.add(rf"\b{re.escape(parent_name)}\b")
    return pats


def _find_irqs(lines: list[str], candidates: set[str]) -> list[int]:
    pats = [re.compile(c) for c in candidates]
    out = []
    for line in lines:
        m = re.match(r"^\s*(\d+):", line)
        if m and any(p.search(line) for p in pats):
            out.append(int(m.group(1)))
    return out


def set_irq_affinity(device_name: str, node: int) -> int:
    """Steer *device_name*'s IRQs to *node*'s CPUs via
    /proc/irq/N/smp_affinity_list. Needs root; returns how many IRQs moved."""
    cpus = node_cpus(node)
    if not cpus:
        return 0
    cpulist = ",".join(str(c) for c in sorted(cpus))
    try:
        with open("/proc/interrupts") as f:
            lines = f.readlines()
    except OSError:
        return 0
    parent = None
    try:
        parent = os.path.basename(
            os.path.realpath(f"/sys/block/{device_name}/device"))
    except OSError:
        pass
    moved = 0
    for irq in _find_irqs(lines, _irq_candidates(device_name, parent)):
        try:
            with open(f"/proc/irq/{irq}/smp_affinity_list", "w") as f:
                f.write(cpulist)
            moved += 1
        except OSError:
            continue
    return moved


@dataclasses.dataclass
class NumaAffinity:
    """Per-context affinity state: resolves the target node once, pins each
    submitting thread once (thread-local), mbinds slabs on request."""

    node: int = -1               # -1: resolve from the first file's device
    steer_irqs: bool = False
    _tls: threading.local = dataclasses.field(default_factory=threading.local)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    _irqs_done: bool = False

    def resolve(self, path: str | None) -> int | None:
        """The node to use, discovering it from *path*'s device if needed.
        O(1) once resolved (node -2 = probed, unknown → permanent no-op)."""
        with self._lock:
            if self.node >= 0:
                # an explicitly-configured node still needs the device lookup
                # once if IRQ steering was asked for — the IRQs belong to the
                # device, not the node
                if self.steer_irqs and not self._irqs_done and path is not None:
                    self._irqs_done = True
                    from strom_torch.probe.topology import device_for_file

                    try:
                        dev = device_for_file(path)
                    except OSError:
                        dev = None
                    if dev is not None:
                        set_irq_affinity(dev.name, self.node)
                return self.node
            if self.node == -2 or path is None:
                return None
            from strom_torch.probe.topology import device_for_file

            try:
                dev = device_for_file(path)
            except OSError:
                dev = None
            if dev is None or dev.numa_node is None:
                self.node = -2  # resolved: unknown → stay no-op
            else:
                self.node = dev.numa_node
                if self.steer_irqs and not self._irqs_done:
                    self._irqs_done = True
                    set_irq_affinity(dev.name, dev.numa_node)
            return self.node if self.node >= 0 else None

    def ensure_thread(self, path: str | None = None) -> bool:
        """Pin the calling thread to the target node (once per thread; the
        outcome is cached per thread once resolution is final)."""
        if getattr(self._tls, "done", False):
            return self._tls.ok
        node = self.resolve(path)
        if node is None:
            if self.node == -2:  # final: nothing to pin to, stop asking
                self._tls.done, self._tls.ok = True, False
            return False
        ok = pin_current_thread(node)
        self._tls.done, self._tls.ok = True, ok
        return ok

    def bind(self, arr: np.ndarray) -> bool:
        node = self.node if self.node >= 0 else None
        return mbind_array(arr, node) if node is not None else False
