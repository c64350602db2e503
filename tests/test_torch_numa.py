"""The port's NUMA affinity (``strom_torch/utils/numa.py``) held to the JAX
package's ``strom/utils/numa.py``: the reference's nine cases run against
the port, the IRQ name matching gives the reference's IRQs on the same
``/proc/interrupts`` lines, IRQ steering writes only a fake ``/proc``, a
pinning slab pool binds a fresh slab before it pins it (``mbind`` cannot
move pinned pages), and a delivery with ``numa_affinity`` on is exact.

This host may have one node (node0): the real syscalls run against node 0
where sysfs shows it, the no-op paths everywhere else."""

import builtins
import os

import numpy as np
import pytest

import strom.utils.numa as jnuma
import strom_torch.utils.numa as tnuma
from strom_torch.config import StromConfig
from strom_torch.delivery import buffers
from strom_torch.delivery.buffers import SlabPool, alloc_aligned
from strom_torch.delivery.core import StromContext
from strom_torch.utils.numa import (NumaAffinity, mbind_array, node_cpus,
                                    pin_current_thread, set_irq_affinity)

_HAS_NODE0 = os.path.isdir("/sys/devices/system/node/node0")


class TestPrimitives:
    @pytest.mark.skipif(not _HAS_NODE0, reason="no sysfs NUMA topology")
    def test_node_cpus(self):
        cpus = node_cpus(0)
        assert cpus and all(isinstance(c, int) for c in cpus)
        assert cpus == jnuma.node_cpus(0)
        assert node_cpus(4096) == set()

    @pytest.mark.skipif(not _HAS_NODE0, reason="no sysfs NUMA topology")
    def test_pin_current_thread_roundtrip(self):
        before = os.sched_getaffinity(0)
        try:
            assert pin_current_thread(0)
            assert os.sched_getaffinity(0) <= node_cpus(0)
        finally:
            os.sched_setaffinity(0, before)
        assert not pin_current_thread(4096)  # unknown node: False, no raise

    @pytest.mark.skipif(not _HAS_NODE0, reason="no sysfs NUMA topology")
    def test_mbind_array(self):
        arr = alloc_aligned(64 * 1024)
        arr[:] = 7
        ok = mbind_array(arr, 0)
        # best effort: bound, or no syscall number for this arch; the data
        # is never touched
        assert ok in (True, False)
        assert ok == jnuma.mbind_array(alloc_aligned(64 * 1024), 0)
        assert (arr == 7).all()

    def test_irq_affinity_bogus_device(self):
        assert set_irq_affinity("no-such-device-xyz", 0) == 0

    def test_irq_matching_nvme_and_virtio(self):
        """/proc/interrupts names IRQs after the controller (nvme0q1,
        virtio0-requests), never the namespace (nvme0n1) or disk (vda)."""
        lines = [
            "            CPU0       CPU1\n",
            "  24:          0          0  PCI-MSIX nvme0q0\n",
            "  25:       1234          0  PCI-MSIX nvme0q1\n",
            "  26:          0       5678  PCI-MSIX nvme1q1\n",
            "  27:         42          0  virtio0-requests\n",
            "  28:          0          0  virtio1-config\n",
        ]
        f, c = tnuma._find_irqs, tnuma._irq_candidates
        assert f(lines, c("nvme0n1")) == [24, 25]
        assert f(lines, c("vda", "virtio0")) == [27]
        assert f(lines, c("sda")) == []
        dense = [
            " 30:  0  PCI-MSIX nvme1q0\n",
            " 31:  0  PCI-MSIX nvme10q0\n",
            " 32:  0  virtio1-requests\n",
            " 33:  0  virtio10-requests\n",
        ]
        assert f(dense, c("nvme1n1")) == [30]
        assert f(dense, c("vdb", "virtio1")) == [32]

    def test_irq_steering_with_explicit_node(self, tmp_path, monkeypatch):
        """irq_affinity engages with an explicit numa_node too (the IRQs
        belong to the device, which still needs one lookup), once."""
        p = str(tmp_path / "f.bin")
        with open(p, "wb") as f:
            f.write(b"a" * 4096)
        calls = []
        monkeypatch.setattr(tnuma, "set_irq_affinity",
                            lambda name, node: calls.append((name, node)) or 1)
        na = NumaAffinity(node=0, steer_irqs=True)
        assert na.resolve(p) == 0
        na.resolve(p)  # steering runs once, not per call
        assert len(calls) == 1 and calls[0][1] == 0


class TestNumaAffinity:
    @pytest.mark.skipif(not _HAS_NODE0, reason="no sysfs NUMA topology")
    def test_explicit_node(self):
        before = os.sched_getaffinity(0)
        try:
            na = NumaAffinity(node=0)
            assert na.resolve(None) == 0
            assert na.ensure_thread()
            assert na.ensure_thread()  # once a thread
            na.bind(alloc_aligned(4096))
        finally:
            os.sched_setaffinity(0, before)

    def test_auto_resolve_matches_reference(self, tmp_path):
        """Discovery from the file's device gives the reference's node; on
        a host whose disk reports none every call is a no-op."""
        p = str(tmp_path / "f.bin")
        with open(p, "wb") as f:
            f.write(b"a" * 4096)
        na = NumaAffinity(node=-1)
        node = na.resolve(p)
        assert node == jnuma.NumaAffinity(node=-1).resolve(p)
        if node is None:
            assert not na.ensure_thread(p)
            assert not na.bind(alloc_aligned(4096))

    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    def test_delivery_integration(self, tmp_path, pkg):
        """numa_affinity=True changes no delivered byte, in either
        package."""
        p = str(tmp_path / "g.bin")
        golden = np.random.default_rng(11).integers(0, 256, size=64 * 1024,
                                                    dtype=np.uint8)
        golden.tofile(p)
        if pkg == "torch":
            cfg_cls, ctx_cls = StromConfig, StromContext
        else:
            from strom.config import StromConfig as cfg_cls
            from strom.delivery.core import StromContext as ctx_cls
        before = os.sched_getaffinity(0)
        ctx = ctx_cls(cfg_cls(engine="python", queue_depth=8, num_buffers=8,
                              numa_affinity=True,
                              numa_node=0 if _HAS_NODE0 else -1))
        try:
            np.testing.assert_array_equal(ctx.pread(p, length=64 * 1024),
                                          golden)
        finally:
            ctx.close()
            os.sched_setaffinity(0, before)


def test_config_fields_match_reference(monkeypatch):
    """``numa_affinity``, ``numa_node`` and ``irq_affinity``: the
    reference's defaults and STROM_* switches."""
    from strom.config import StromConfig as JConfig

    for k in ("numa_affinity", "numa_node", "irq_affinity"):
        assert getattr(StromConfig(), k) == getattr(JConfig(), k), k
    monkeypatch.setenv("STROM_NUMA_AFFINITY", "1")
    monkeypatch.setenv("STROM_NUMA_NODE", "3")
    monkeypatch.setenv("STROM_IRQ_AFFINITY", "true")
    t, j = StromConfig.from_env(), JConfig.from_env()
    for k in ("numa_affinity", "numa_node", "irq_affinity"):
        assert getattr(t, k) == getattr(j, k), k
    assert (t.numa_affinity, t.numa_node, t.irq_affinity) == (True, 3, True)


@pytest.mark.parametrize("lines", [
    ["  24: 0 PCI-MSIX nvme0q0\n", "  25: 1 PCI-MSIX nvme0q1\n",
     "  40: 0 PCI-MSIX nvme0n1\n", " 41: 2 IO-APIC nvme01q3\n"],
    ["  7: 0 virtio2-requests\n", "  8: 0 virtio2-config\n",
     "  9: 0 virtio20-requests\n", "NMI: 0 Non-maskable interrupts\n"],
    ["  3: 9 xhci_hcd\n", " 11: 0 sda\n", " 12: 0 ahci[0000:00:1f.2] sdb\n"],
])
@pytest.mark.parametrize("dev,parent", [
    ("nvme0n1", None), ("nvme0n1", "0000:01:00.0"), ("vdc", "virtio2"),
    ("sda", None), ("sdb", "ata1"), ("nvme01n1", None),
])
def test_irq_names_match_reference(lines, dev, parent):
    """The same /proc/interrupts lines give the same candidates and IRQs."""
    tc = tnuma._irq_candidates(dev, parent)
    assert tc == jnuma._irq_candidates(dev, parent)
    assert tnuma._find_irqs(lines, tc) == jnuma._find_irqs(lines, tc)


@pytest.fixture()
def fake_root(tmp_path, monkeypatch):
    """A fake /proc and /sys: the numa module's opens of /proc and /sys
    paths land under *tmp_path*; nothing of the host's is written."""
    root = tmp_path / "root"
    (root / "proc" / "irq").mkdir(parents=True)
    (root / "sys" / "devices" / "system" / "node" / "node1").mkdir(
        parents=True)
    (root / "sys" / "devices" / "system" / "node" / "node1" /
     "cpulist").write_text("2-3,6\n")
    (root / "proc" / "interrupts").write_text(
        "            CPU0       CPU1\n"
        "  24:          0          0  PCI-MSIX nvme0q0\n"
        "  25:       1234          0  PCI-MSIX nvme0q1\n"
        "  26:          0       5678  PCI-MSIX nvme1q1\n"
        "  27:         42          0  virtio0-requests\n")
    for irq in (24, 25, 26, 27):
        (root / "proc" / "irq" / str(irq)).mkdir()
        (root / "proc" / "irq" / str(irq) / "smp_affinity_list").write_text(
            "0-7\n")
    real_open = builtins.open

    def fake_open(path, *a, **kw):
        p = os.fspath(path)
        if p.startswith(("/proc/", "/sys/")):
            p = str(root) + p
        return real_open(p, *a, **kw)

    monkeypatch.setattr(tnuma, "open", fake_open, raising=False)
    return root


def test_irq_steering_writes_only_the_fake_proc(fake_root):
    """set_irq_affinity writes node 1's CPU list into each of the
    controller's IRQs and no other."""
    assert tnuma.node_cpus(1) == {2, 3, 6}
    assert set_irq_affinity("nvme0n1", 1) == 2
    got = {irq: (fake_root / "proc" / "irq" / str(irq) /
                 "smp_affinity_list").read_text()
           for irq in (24, 25, 26, 27)}
    assert got == {24: "2,3,6", 25: "2,3,6", 26: "0-7\n", 27: "0-7\n"}
    # an unknown node moves nothing
    assert set_irq_affinity("nvme1n1", 5) == 0
    assert (fake_root / "proc" / "irq" / "26" /
            "smp_affinity_list").read_text() == "0-7\n"


def test_affinity_steers_once_through_the_fake_proc(fake_root, tmp_path,
                                                    monkeypatch):
    """NumaAffinity(steer_irqs=True) on an explicit node looks the file's
    device up once and steers its IRQs once."""
    from strom_torch.probe import topology

    p = str(tmp_path / "f.bin")
    with open(p, "wb") as f:
        f.write(b"a" * 4096)
    monkeypatch.setattr(topology, "device_for_file",
                        lambda path: topology.BlockDevice(
                            name="nvme0n1", major=259, minor=0, is_nvme=True,
                            is_rotational=False, logical_block_size=512,
                            queue_depth=1023, max_sectors_kb=128,
                            raid_level=None, raid_chunk_bytes=None,
                            raid_members=(), numa_node=1))
    na = NumaAffinity(node=1, steer_irqs=True)
    assert na.resolve(p) == 1
    assert na.resolve(p) == 1
    assert (fake_root / "proc" / "irq" / "25" /
            "smp_affinity_list").read_text() == "2,3,6"
    # discovery from the device gives its node
    na2 = NumaAffinity(node=-1)
    assert na2.resolve(p) == 1


def test_pool_binds_a_fresh_slab_before_it_pins_it(monkeypatch):
    """A pinning pool runs its placement on a fresh slab first, then
    cudaHostRegister, then the ring registration; a recycled slab is
    neither placed nor pinned again."""
    events = []
    monkeypatch.setattr(buffers, "host_register",
                        lambda arr: events.append(("pin", arr.nbytes)))
    monkeypatch.setattr(buffers, "host_unregister",
                        lambda arr: events.append(("unpin", arr.nbytes)))
    pool = SlabPool(1 << 20, pin=True,
                    on_alloc=lambda a: events.append(("ring", a.nbytes)),
                    on_free=lambda a: events.append(("unring", a.nbytes)),
                    place=lambda a: events.append(
                        ("place", a.nbytes, bool(a.flags.writeable))))
    a = pool.acquire(8192)
    assert [e[0] for e in events] == ["place", "pin", "ring"]
    pool.release(a)
    b = pool.acquire(8192)      # recycled: no second place or pin
    assert [e[0] for e in events] == ["place", "pin", "ring"]
    pool.release(b)
    pool.close()
    assert [e[0] for e in events] == ["place", "pin", "ring", "unring",
                                      "unpin"]


def test_context_places_pool_slabs_with_its_affinity(monkeypatch):
    """With numa_affinity on, the context hands the pool its affinity's
    bind as the placement; off, the pool places nothing."""
    on = StromContext(StromConfig(engine="python", numa_affinity=True,
                                  numa_node=0))
    off = StromContext(StromConfig(engine="python"))
    try:
        assert on._slab_pool._place == on._numa.bind
        assert off._numa is None and off._slab_pool._place is None
    finally:
        on.close()
        off.close()


@pytest.fixture()
def discovered_node1(monkeypatch):
    """Node discovery that finds the disk on node 1, pinning and mbind
    recorded instead of made: the addresses bound, each with its node."""
    import types

    import strom_torch.probe.topology as topology

    bound = {}
    monkeypatch.setattr(topology, "device_for_file", lambda p: types.
                        SimpleNamespace(name="nvme0n1", numa_node=1))
    monkeypatch.setattr(tnuma, "pin_current_thread", lambda node: True)
    monkeypatch.setattr(tnuma, "mbind_array", lambda arr, node: bound.
                        setdefault(buffers.buf_addr(arr), node) is not None)
    monkeypatch.setattr(buffers, "host_register", lambda arr: None)
    monkeypatch.setattr(buffers, "host_unregister", lambda arr: None)
    return bound


def _affine_ctx():
    return StromContext(StromConfig(engine="python", numa_affinity=True))


def test_first_buffers_bind_to_the_discovered_node(discovered_node1,
                                                   tmp_path):
    """With numa_node left to discovery, the node is resolved from the
    source before the first buffer is made: a pinned pool slab from
    host_batch, pread's and memcpy_ssd2host's fresh buffers and
    alloc_read_buffer's are each bound to the disk's node."""
    import torch

    p = tmp_path / "f.bin"
    data = np.random.default_rng(5).integers(0, 256, 1 << 16, dtype=np.uint8)
    p.write_bytes(data.tobytes())
    cuda = torch.device("cuda")
    ctx = _affine_ctx()
    try:
        slab = ctx.host_batch((8192,), cuda, source=str(p))
        assert discovered_node1 == {buffers.buf_addr(slab): 1}
        ctx.release_host_batch(slab, cuda)
    finally:
        ctx.close()
    for make in (lambda c: c.pread(str(p)),
                 lambda c: c.memcpy_ssd2host(str(p)),
                 lambda c: c.alloc_read_buffer(str(p), 4096)):
        discovered_node1.clear()
        ctx = _affine_ctx()
        try:
            buf = make(ctx)
        finally:
            ctx.close()
        assert discovered_node1.get(buffers.buf_addr(buf)) == 1
        if buf.nbytes == data.nbytes:
            assert np.array_equal(buf, data)


def test_a_scans_first_slab_binds_to_the_discovered_node(discovered_node1,
                                                         tmp_path):
    """A Parquet scan's host_batch slabs, the first included, are bound to
    the disk's node, and the scan's counts are exact."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from strom_torch.pipelines import parquet_scan_aggregate

    paths = []
    for s in range(2):
        paths.append(str(tmp_path / f"part{s}.parquet"))
        pq.write_table(pa.table({"v": pa.array(np.arange(2000,
                                                         dtype=np.int64))}),
                       paths[-1], row_group_size=500)
    ctx = _affine_ctx()
    batches = []
    real = ctx.host_batch

    def host_batch(shape, device, **kw):
        arr = real(shape, device, **kw)
        batches.append(buffers.buf_addr(arr))
        return arr

    ctx.host_batch = host_batch
    try:
        out = parquet_scan_aggregate(
            ctx, paths, ["v"], lambda cols: {"n": cols["v"].numel()},
            devices=["cpu"])
    finally:
        ctx.close()
    assert out["n"] == 4000
    assert batches and all(discovered_node1.get(a) == 1 for a in batches)
