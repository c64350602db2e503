"""The port's probe layer and the rest of its top-level API against the JAX
package's on the CPU, on the same files: FIEMAP extents, fragmentation and
coverage; page-cache residency; block-device topology over a fake sysfs
tree; ``check_file`` of a plain, a sparse, a missing, a warm and a striped
file, field for field; extent-aware planning (``plan_chunks_multi`` on
random inputs, and ``_plan_chunks`` with ``extent_aware`` on and off); the
preadv pool's residency hybrid; ``memcpy_ssd2host``, ``buffer_info``,
``map_buffers`` and ``stats()`` with no context."""

import dataclasses
import importlib
import os

import numpy as np
import pytest

import strom_torch
from strom.config import StromConfig as JConfig
from strom.delivery import chunk_plan as jplan
from strom.delivery.core import StripedFile as JStripedFile
from strom.delivery.core import StromContext as JContext
from strom.delivery.extents import Extent as JExtent
from strom.delivery.extents import ExtentList as JExtentList
from strom.delivery.shard import Segment as JSegment
from strom.engine.python_engine import PythonEngine as JPythonEngine
from strom.probe import check as jcheck
from strom.probe import residency as jres
from strom.probe import topology as jtopo
from strom_torch.config import StromConfig
from strom_torch.delivery import chunk_plan as tplan
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.core import StripedFile, StromContext
from strom_torch.delivery.extents import Extent, ExtentList
from strom_torch.delivery.shard import Segment
from strom_torch.engine.python_engine import PythonEngine
from strom_torch.engine.raid0 import stripe_file
from strom_torch.probe import check as tcheck
from strom_torch.probe import fiemap as tfiemap
from strom_torch.probe import residency as tres
from strom_torch.probe import topology as ttopo

# the module, not the function strom.probe re-exports under the same name
jfiemap = importlib.import_module("strom.probe.fiemap")
MiB = 1 << 20


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


@pytest.fixture()
def files(tmp_path):
    """A plain 3 MiB file and a sparse one (a hole between two written
    MiB), both on disk."""
    rng = np.random.default_rng(0)
    plain = str(tmp_path / "plain.bin")
    _write(plain, rng.bytes(3 * MiB))
    sparse = str(tmp_path / "sparse.bin")
    with open(sparse, "wb") as f:
        f.write(rng.bytes(MiB))
        f.seek(4 * MiB)
        f.write(rng.bytes(MiB))
        f.flush()
        os.fsync(f.fileno())
    return plain, sparse


def _ext(e) -> tuple:
    return (e.logical, e.physical, e.length, e.flags, e.is_reliable,
            e.is_last, e.is_unwritten)


def _report(r) -> dict:
    d = dataclasses.asdict(r)
    d["tier"] = r.tier.value
    d["supported"] = r.supported
    return d


def test_fiemap_fragmentation_coverage_match(files):
    for path in files:
        got, want = tfiemap.fiemap(path), jfiemap.fiemap(path)
        assert [_ext(e) for e in got] == [_ext(e) for e in want] != []
        size = os.path.getsize(path)
        assert tfiemap.fragmentation(got) == jfiemap.fragmentation(want)
        assert tfiemap.coverage(got, size) == jfiemap.coverage(want, size)
    # the sparse file's hole is not covered
    assert tfiemap.coverage(tfiemap.fiemap(files[1]), 5 * MiB) < 1.0
    # synthetic maps: fragmented, unreliable, past EOF, empty
    raw = [(0, 10 * MiB, MiB, 0), (MiB, 50 * MiB, MiB, 0),
           (2 * MiB, 11 * MiB, MiB, jfiemap.FIEMAP_EXTENT_DELALLOC),
           (3 * MiB, 12 * MiB, 2 * MiB, jfiemap.FIEMAP_EXTENT_LAST)]
    t = [tfiemap.Extent(*x) for x in raw]
    j = [jfiemap.Extent(*x) for x in raw]
    for sub in (slice(None), slice(0, 2), slice(3, 4), slice(0, 0)):
        assert tfiemap.fragmentation(t[sub]) == jfiemap.fragmentation(j[sub])
        assert tfiemap.coverage(t[sub], 4 * MiB) == jfiemap.coverage(j[sub], 4 * MiB)


def test_cached_pages_match(files):
    plain, _ = files
    fd = os.open(plain, os.O_RDONLY)
    try:
        os.pread(fd, 3 * MiB, 0)                     # warm every page
        warm = tres.cached_pages(fd, 0, 3 * MiB)
        assert warm == jres.cached_pages(fd, 0, 3 * MiB)
        assert warm[0] == warm[1] == 3 * MiB // os.sysconf("SC_PAGE_SIZE")
        assert tres.range_fully_cached(fd, 4096, 8192) is True
        assert tres.cached_pages(fd, 5, 0) == jres.cached_pages(fd, 5, 0)
    finally:
        os.close(fd)
    tres.drop_cache(plain)
    fd = os.open(plain, os.O_RDONLY)
    try:
        cold = tres.cached_pages(fd, 0, 3 * MiB)
        assert cold == jres.cached_pages(fd, 0, 3 * MiB)
        assert tres.range_fully_cached(fd, 0, 3 * MiB) == \
            jres.range_fully_cached(fd, 0, 3 * MiB)
    finally:
        os.close(fd)


def test_check_file_plain_sparse_warm_missing_match(files, tmp_path):
    plain, sparse = files
    tres.drop_cache(plain)
    for path in (plain, sparse):
        for want_extents in (True, False):
            assert _report(tcheck.check_file(path, want_extents=want_extents)) \
                == _report(jcheck.check_file(path, want_extents=want_extents))
    with open(plain, "rb") as f:
        f.read()                                     # now warm
    got = tcheck.check_file(plain)
    assert _report(got) == _report(jcheck.check_file(plain))
    assert got.cached_frac == 1.0 and got.size == 3 * MiB
    empty = str(tmp_path / "empty.bin")
    open(empty, "wb").close()
    assert _report(tcheck.check_file(empty)) == _report(jcheck.check_file(empty))
    for check in (tcheck.check_file, jcheck.check_file):
        with pytest.raises(FileNotFoundError):
            check(str(tmp_path / "missing.bin"))


def test_check_file_striped_matches(files, tmp_path):
    plain, _ = files
    members = [str(tmp_path / f"m{i}.bin") for i in range(4)]
    stripe_file(plain, members, 64 * 1024)
    got = tcheck.check_file(StripedFile(tuple(members), 64 * 1024))
    want = jcheck.check_file(JStripedFile(tuple(members), 64 * 1024))
    assert _report(got) == _report(want)
    assert got.path == "+".join(members) and got.size == 3 * MiB
    assert got.tier == min((tcheck.check_file(m).tier for m in members),
                           key=lambda t: tcheck._TIER_RANK[t])


def _fake_disk(root, name: str, dev: str, *, rotational=0, md=None,
               numa=None, partition: str | None = None) -> str:
    """A /sys/block/<name> node (and optionally one partition under it)."""
    disk = os.path.join(root, "block", name)
    os.makedirs(os.path.join(disk, "queue"))
    for f, v in (("dev", dev),):
        open(os.path.join(disk, f), "w").write(v + "\n")
    for f, v in (("rotational", rotational), ("logical_block_size", 512),
                 ("nr_requests", 1023), ("max_sectors_kb", 1280)):
        open(os.path.join(disk, "queue", f), "w").write(f"{v}\n")
    if numa is not None:
        os.makedirs(os.path.join(disk, "device", "device"))
        open(os.path.join(disk, "device", "device", "numa_node"), "w").write(
            f"{numa}\n")
    if md is not None:
        level, chunk, members = md
        os.makedirs(os.path.join(disk, "md"))
        open(os.path.join(disk, "md", "level"), "w").write(level + "\n")
        open(os.path.join(disk, "md", "chunk_size"), "w").write(f"{chunk}\n")
        for i, m in enumerate(members):
            rd = os.path.join(disk, "md", f"rd{i}")
            os.makedirs(rd)
            os.symlink(os.path.join(root, "block", m), os.path.join(rd, "block"))
    node = disk
    if partition is not None:
        node = os.path.join(disk, partition)
        os.makedirs(node)
        open(os.path.join(node, "partition"), "w").write("1\n")
    return node


@pytest.mark.parametrize("kind", ["nvme-partition", "raid0-nvme", "ssd", "hdd"])
def test_topology_over_fake_sysfs(tmp_path, kind):
    """device_for_file resolves the file's st_dev through the fake tree;
    every field of the BlockDevice and list_nvme_devices equal the
    reference's."""
    root = str(tmp_path / "sys")
    path = str(tmp_path / "f.bin")
    open(path, "wb").write(b"x")
    st = os.stat(path)
    majmin = f"{os.major(st.st_dev)}:{os.minor(st.st_dev)}"
    for i in range(2):
        _fake_disk(root, f"nvme{i}n1", f"259:{i}", numa=i)
    if kind == "nvme-partition":
        node = _fake_disk(root, "nvme7n1", "259:7", numa=1,
                          partition="nvme7n1p1")
    elif kind == "raid0-nvme":
        node = _fake_disk(root, "md0", "9:0",
                          md=("raid0", 524288, ["nvme0n1", "nvme1n1"]))
    else:
        node = _fake_disk(root, "sda", "8:0",
                          rotational=int(kind == "hdd"))
    os.makedirs(os.path.join(root, "dev", "block"))
    os.symlink(node, os.path.join(root, "dev", "block", majmin))
    got = ttopo.device_for_file(path, sysfs=root)
    want = jtopo.device_for_file(path, sysfs=root)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.fast_class == want.fast_class == {
        "nvme-partition": "nvme", "raid0-nvme": "raid0-nvme", "ssd": "ssd",
        "hdd": "hdd"}[kind]
    assert [dataclasses.asdict(d) for d in ttopo.list_nvme_devices(root)] == \
        [dataclasses.asdict(d) for d in jtopo.list_nvme_devices(root)]
    assert ttopo.list_nvme_devices(str(tmp_path / "nowhere")) == []
    assert ttopo.device_for_file(path, sysfs=str(tmp_path / "nowhere")) is None


# ----------------------------------------------------- extent-aware planning
def _random_map(rng, size: int, n: int) -> list[tuple]:
    """n extents tiling [0, size) at shuffled physical places, some
    unreliable, with a hole."""
    cuts = sorted(rng.choice(np.arange(1, size // 4096), n - 1, replace=False))
    bounds = [0, *(int(c) * 4096 for c in cuts), size]
    phys = rng.permutation(n) * (size + 4096 * 7)
    out = []
    for i in range(n):
        lo, hi = bounds[i], bounds[i + 1]
        if i == n // 2:
            continue                                 # a hole
        flags = jfiemap.FIEMAP_EXTENT_UNKNOWN if i % 5 == 3 else 0
        out.append((lo, int(phys[i]), hi - lo, flags))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_plan_chunks_multi_matches_on_random_inputs(seed):
    rng = np.random.default_rng(seed)
    size = 4 * MiB
    chunks = []
    dest = 0
    for _ in range(int(rng.integers(1, 40))):
        fi = int(rng.integers(0, 3))
        off = int(rng.integers(0, size - 65536))
        ln = int(rng.integers(1, 65536))
        chunks.append((fi, off, dest, ln))
        dest += ln
    maps = {fi: _random_map(rng, size, int(rng.integers(1, 9)))
            for fi in range(2)}                      # file 2 has no map
    got = tplan.plan_chunks_multi(
        chunks, {fi: [tfiemap.Extent(*e) for e in m] for fi, m in maps.items()})
    want = jplan.plan_chunks_multi(
        chunks, {fi: [jfiemap.Extent(*e) for e in m] for fi, m in maps.items()})
    assert got == want
    # the plan covers the same file -> dest bytes
    def cover(cs):
        return sorted((fi, off + i, d + i) for fi, off, d, ln in cs
                      for i in (0, ln - 1))
    assert sum(c[3] for c in got) == sum(c[3] for c in chunks)
    assert {c[0] for c in got} == {c[0] for c in chunks}
    assert cover(got) != [] and len(got) >= 1


def _fragmented(path: str, size: int) -> list[tuple]:
    """A made-up fragmented map of *path*: 4 extents in reverse physical
    order."""
    q = size // 4
    return [(i * q, (4 - i) * 100 * MiB, q, 0) for i in range(4)]


@pytest.mark.parametrize("extent_aware", [True, False])
def test_plan_chunks_extent_aware_matches_reference(files, tmp_path,
                                                    extent_aware):
    """_plan_chunks of a whole-file read, an ExtentList over two files and
    a striped set, with each file's map replaced by a fragmented one: the
    reference's chunk list, reordered physically only where extent_aware
    is on and never for the striped set."""
    plain, sparse = files
    members = [str(tmp_path / f"m{i}.bin") for i in range(2)]
    stripe_file(plain, members, 64 * 1024)
    kw = dict(engine="python", extent_aware=extent_aware, queue_depth=8,
              num_buffers=8)
    tctx, jctx = StromContext(StromConfig(**kw)), JContext(JConfig(**kw))
    asked: list[str] = []   # the paths the port's planner took a map of

    def fake(maps, log):
        return lambda p: (log.append(p), maps.get(p))[1]

    try:
        for ctx, E, log in ((tctx, tfiemap.Extent, asked),
                            (jctx, jfiemap.Extent, [])):
            maps = {p: [E(*e) for e in _fragmented(p, os.path.getsize(p))]
                    for p in (plain, sparse, *members)}
            ctx.extent_map = fake(maps, log)
        srcs = [
            (plain, plain, [Segment(0, 0, 3 * MiB)],
             [JSegment(0, 0, 3 * MiB)]),
            (ExtentList([Extent(plain, 100, 70000), Extent(sparse, 0, 9000),
                         Extent(plain, 2 * MiB, 5000)]),
             JExtentList([JExtent(plain, 100, 70000), JExtent(sparse, 0, 9000),
                          JExtent(plain, 2 * MiB, 5000)]),
             [Segment(0, 0, 84000)], [JSegment(0, 0, 84000)]),
            (StripedFile(tuple(members), 64 * 1024),
             JStripedFile(tuple(members), 64 * 1024),
             [Segment(0, 0, 3 * MiB)], [JSegment(0, 0, 3 * MiB)]),
        ]
        for tsrc, jsrc, tsegs, jsegs in srcs:
            del asked[:]
            got = tctx._plan_chunks(tsrc, tsegs)
            want, _ = jctx._plan_chunks(jsrc, jsegs)
            assert got == want
            if isinstance(tsrc, StripedFile):   # exempt: no map is taken
                assert asked == []
                continue
            assert bool(asked) == extent_aware
        # the whole-file read: its last quarter lies first on the device
        first = tctx._plan_chunks(plain, [Segment(0, 0, 3 * MiB)])[0]
        assert first[1] == (3 * MiB // 4 * 3 if extent_aware else 0)
        # the real maps of this filesystem: the same plan either way
        del tctx.extent_map, jctx.extent_map
        got = tctx._plan_chunks(plain, [Segment(0, 0, 3 * MiB)])
        assert got == jctx._plan_chunks(plain, [JSegment(0, 0, 3 * MiB)])[0]
        assert tctx.extent_map(plain) is tctx.extent_map(plain)  # cached
    finally:
        tctx.close()
        jctx.close()


# ------------------------------------------------------ the residency hybrid
def _pool_read(engine_cls, config_cls, path: str, size: int, **kw):
    eng = engine_cls(config_cls(engine="python", queue_depth=8,
                                num_buffers=8, **kw))
    try:
        fi = eng.register_file(path)
        dest = alloc_aligned(size)
        assert eng.read_vectored([(fi, 0, 0, size)], dest) == size
        return dest, eng.stats(), eng.file_uses_o_direct(fi)
    finally:
        eng.close()


@pytest.mark.parametrize("hybrid", [True, False])
def test_pool_residency_hybrid(files, hybrid):
    """A warm file through the preadv pool: byte-exact, and all of it
    cached_bytes with the hybrid on, none with it off; a cold one all
    media_bytes. The reference's pool splits the same way."""
    plain, _ = files
    data = open(plain, "rb").read()                  # leaves it warm
    got, st, direct = _pool_read(PythonEngine, StromConfig, plain,
                                 len(data), residency_hybrid=hybrid)
    if not direct:
        pytest.skip("the filesystem refuses O_DIRECT: no hybrid to route")
    assert got.tobytes() == data
    _, jst, _ = _pool_read(JPythonEngine, JConfig, plain, len(data),
                           residency_hybrid=hybrid)
    want = (len(data), 0) if hybrid else (0, len(data))
    assert (st["cached_bytes"], st["media_bytes"]) == want
    assert (jst.get("cached_bytes", 0), jst.get("media_bytes", 0)) == want
    assert (st["residency_probes"] > 0) == hybrid
    tres.drop_cache(plain)
    got, st, _ = _pool_read(PythonEngine, StromConfig, plain, len(data),
                            residency_hybrid=hybrid)
    assert got.tobytes() == data
    assert (st["cached_bytes"], st["media_bytes"]) == (0, len(data))


def test_pool_hybrid_probes_a_stand_alone_op(files):
    """An op outside a gather probes its own piece (no snapshot)."""
    from strom_torch.engine.base import RawRead

    plain, _ = files
    open(plain, "rb").read()
    eng = PythonEngine(StromConfig(engine="python", queue_depth=8,
                                   num_buffers=8))
    try:
        fi = eng.register_file(plain)
        if not eng.file_uses_o_direct(fi):
            pytest.skip("the filesystem refuses O_DIRECT")
        dest = alloc_aligned(MiB)
        eng.submit_raw([RawRead(fi, 0, MiB, dest, 1)])
        (c,) = eng.wait(1)
        st = eng.stats()
        assert c.result == MiB and st["cached_bytes"] == MiB
        assert st["residency_probes"] == 1
    finally:
        eng.close()


# ------------------------------------------------------- the top-level API
def test_memcpy_ssd2host_matches_reference(files):
    plain, _ = files
    data = np.fromfile(plain, dtype=np.uint8)
    kw = dict(engine="python", queue_depth=8, num_buffers=8)
    tctx, jctx = StromContext(StromConfig(**kw)), JContext(JConfig(**kw))
    try:
        got = tctx.memcpy_ssd2host(plain)
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(got, jctx.memcpy_ssd2host(plain))
        typed = tctx.memcpy_ssd2host(plain, offset=4096, shape=(64, 32),
                                     dtype=np.int32)
        np.testing.assert_array_equal(typed, jctx.memcpy_ssd2host(
            plain, offset=4096, shape=(64, 32), dtype=np.int32))
        assert typed.shape == (64, 32) and typed.dtype == np.int32
        out = alloc_aligned(MiB + 4096)
        res = tctx.memcpy_ssd2host(plain, length=MiB, out=out)
        assert np.shares_memory(res, out)            # zero-copy into out
        np.testing.assert_array_equal(res, data[:MiB])
        with pytest.raises(ValueError, match="C-contiguous"):
            tctx.memcpy_ssd2host(plain, length=4096, out=out[::2])
        with pytest.raises(ValueError, match="need"):
            tctx.memcpy_ssd2host(plain, length=MiB, out=out[:4096])
        assert tctx.buffer_info() == jctx.buffer_info() == {
            "num_buffers": 8, "buffer_size": 128 * 1024,
            "total_bytes": 8 * 128 * 1024, "engine": "python"}
        assert tctx.stats()["ssd2gpu_bytes"] == 3 * MiB + 8192 + MiB
    finally:
        tctx.close()
        jctx.close()
    tctx.close()
    with pytest.raises(RuntimeError, match="closed"):
        tctx.memcpy_ssd2host(plain)


def test_module_level_probe_and_buffers(files, tmp_path):
    plain, _ = files
    strom_torch.close()
    # check_file creates no context; stats() does, as the reference's
    assert strom_torch.check_file(plain).size == 3 * MiB
    assert strom_torch._ctx is None
    try:
        assert strom_torch.stats()["transfers"] == 0
        assert strom_torch._ctx is not None
        strom_torch.init(StromConfig(engine="python", queue_depth=8,
                                     num_buffers=4))
        bufs = strom_torch.map_buffers()
        info = strom_torch.buffer_info()
        assert len(bufs) == info["num_buffers"] == 4
        assert all(b.nbytes == info["buffer_size"] for b in bufs)
        bufs[2][:5] = 7                              # views, not copies
        assert (strom_torch.context().engine.buffer(2)[:5] == 7).all()
        np.testing.assert_array_equal(
            strom_torch.memcpy_ssd2host(plain, length=8192),
            np.fromfile(plain, dtype=np.uint8, count=8192))
        # a path aliased to a striped set is checked as that set
        members = [str(tmp_path / f"m{i}.bin") for i in range(4)]
        stripe_file(plain, members, 64 * 1024)
        strom_torch.register_striped(str(tmp_path / "alias"), members,
                                     64 * 1024)
        rep = strom_torch.check_file(str(tmp_path / "alias"))
        assert rep.path == "+".join(members) and rep.size == 3 * MiB
    finally:
        strom_torch.close()
