"""The port's native io_uring engine against the JAX package's, on the CPU.

The same gather lists (aligned and unaligned, several files, O_DIRECT and
buffered) go through ``strom_torch.engine.uring_engine.UringEngine`` and
``strom.engine.uring_engine.UringEngine``: same bytes, same return values,
same errno. Also fault injection with retries, READ_FIXED into a registered
slab, engine selection, the multi-ring fan-out, the ctypes struct layouts,
the pool slabs' ring registration, and the library build across processes.
Every test that needs a ring skips only where the kernel refuses one.
"""

import ctypes
import errno
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import strom.engine.uring_engine as j_ue
from strom.config import StromConfig as JConfig
from strom.engine import make_engine as j_make_engine
from strom.engine.base import EngineError as JEngineError
from strom.engine.multi import MultiRingEngine as JMulti
from strom_torch._core import build as core_build
from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.core import StromContext
from strom_torch.engine import make_engine
from strom_torch.engine import uring_engine as ue
from strom_torch.engine.base import EngineError
from strom_torch.engine.multi import MultiRingEngine
from strom_torch.engine.python_engine import PythonEngine

MiB = 1024 * 1024
SMALL = dict(queue_depth=8, num_buffers=8)


@pytest.fixture()
def uring():
    if not ue.uring_available():
        pytest.skip(f"io_uring unavailable: {ue.unavailable_reason}")


def write_cold(path: str, data: np.ndarray) -> None:
    """Write *data* and drop its pages from the page cache, so the residency
    hybrid routes the reads O_DIRECT to the device."""
    with open(path, "wb") as f:
        data.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    drop_cache(path)


def drop_cache(path: str) -> None:
    """Evict *path* from the page cache. Buffered reads (an unaligned op)
    warm it, and the residency hybrid then routes and chunks the next
    engine's reads differently: each engine starts from a cold file."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


@pytest.fixture()
def files(tmp_path):
    """Two cold files: 4 MiB + 777 bytes (an unaligned tail) and 100,001."""
    rng = np.random.default_rng(7)
    out = []
    for i, n in enumerate((4 * MiB + 777, 100_001)):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        path = str(tmp_path / f"f{i}.bin")
        write_cold(path, data)
        out.append((path, data))
    return out


def pair(**kw):
    """(port engine, reference engine) built from one config."""
    return ue.UringEngine(StromConfig(**SMALL, **kw)), \
        j_ue.UringEngine(JConfig(**SMALL, **kw))


def gather(eng, paths, plan, o_direct, size):
    for p in paths:
        drop_cache(p)
    fis = [eng.register_file(p, o_direct=o_direct) for p in paths]
    dest = alloc_aligned(size)
    dest[:] = 0
    n = eng.read_vectored([(fis[f], fo, do, ln) for f, fo, do, ln in plan],
                          dest)
    return n, dest


# (file, file_offset, dest_offset, length) over the two files
PLANS = {
    "aligned": [(0, 0, 0, 2 * MiB), (0, 3 * MiB, 2 * MiB, MiB)],
    "unaligned": [(0, 5, 0, 100_000), (0, MiB + 17, 100_000, 300_001),
                  (0, 4 * MiB - 4096, 400_001, 4096 + 777)],   # to EOF
    "two_files": [(1, 0, 0, 100_001), (0, 8192, 100_001, 3 * MiB),
                  (1, 4095, 3 * MiB + 100_001, 50_000)],
}


@pytest.mark.parametrize("o_direct", [True, False])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_gathers_match_reference(uring, files, plan, o_direct):
    paths = [p for p, _ in files]
    steps = PLANS[plan]
    size = max(do + ln for _, _, do, ln in steps)
    want = np.zeros(size, dtype=np.uint8)
    for f, fo, do, ln in steps:
        want[do: do + ln] = files[f][1][fo: fo + ln]
    tp, jp = pair()
    try:
        got_n, got = gather(tp, paths, steps, o_direct, size)
        ref_n, ref = gather(jp, paths, steps, o_direct, size)
        assert got_n == ref_n == sum(ln for *_, ln in steps)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
        assert tp.file_uses_o_direct(0) == jp.file_uses_o_direct(0)
        for key in ("bytes_read", "ops_errored", "unaligned_fallback_reads",
                    "eof_topup_reads", "in_flight"):
            assert tp.stats()[key] == jp.stats()[key], key
    finally:
        tp.close()
        jp.close()


def test_read_past_eof_gives_enodata(uring, files):
    path, data = files[0]
    tp, jp = pair()
    try:
        errs = []
        for eng, exc in ((tp, EngineError), (jp, JEngineError)):
            fi = eng.register_file(path)
            with pytest.raises(exc) as info:
                eng.read_vectored([(fi, len(data) - 1000, 0, 8192)],
                                  alloc_aligned(8192))
            errs.append(info.value.errno)
            assert eng.in_flight() == 0
        assert errs == [errno.ENODATA, errno.ENODATA]
        # a file index that was never registered: the same errno on both
        errs = []
        for eng, exc in ((tp, EngineError), (jp, JEngineError)):
            with pytest.raises(exc) as info:
                eng.read_vectored([(99, 0, 0, 4096)], alloc_aligned(4096))
            errs.append(info.value.errno)
        assert errs[0] == errs[1] == errno.EBADF
    finally:
        tp.close()
        jp.close()


def test_fault_injection_retries_deliver_exact_bytes(uring, files):
    """Every third op fails with EIO; one retry each recovers it. Queue
    depth 1 keeps the op numbering, and so which ops fault, the same on
    both engines (a retry is always the op after a faulted one)."""
    path, data = files[0]
    kw = dict(fault_every=3, io_retries=1, queue_depth=1, num_buffers=1)
    tp = ue.UringEngine(StromConfig(**kw))
    jp = j_ue.UringEngine(JConfig(**kw))
    try:
        for eng in (tp, jp):
            drop_cache(path)
            fi = eng.register_file(path)
            dest = alloc_aligned(2 * MiB + 5)
            assert eng.read_vectored([(fi, 11, 0, 2 * MiB + 5)], dest,
                                     retries=1) == 2 * MiB + 5
            np.testing.assert_array_equal(dest, data[11: 11 + 2 * MiB + 5])
        ts, js = tp.stats(), jp.stats()
        assert ts["chunk_retries"] > 0 and ts["ops_faulted"] > 0
        for key in ("chunk_retries", "ops_faulted", "ops_submitted"):
            assert ts[key] == js[key], key
    finally:
        tp.close()
        jp.close()


def test_cold_read_into_registered_slab_rides_read_fixed(uring, files):
    path, data = files[0]
    for eng in pair():
        try:
            if not eng.stats()["sparse_table"]:
                pytest.skip("the kernel lacks the sparse buffer table")
            fi = eng.register_file(path)
            assert eng.file_uses_o_direct(fi)
            slab = alloc_aligned(4 * MiB)
            assert eng.register_dest(slab) >= eng.config.num_buffers
            # a view strictly inside the registered entry rides it too
            assert eng.read_vectored([(fi, 0, 0, MiB), (fi, 2 * MiB, MiB, MiB)],
                                     slab[MiB:]) == 2 * MiB
            assert eng.read_vectored([(fi, MiB, 0, MiB)], slab) == MiB
            np.testing.assert_array_equal(slab[MiB: 3 * MiB], np.concatenate(
                [data[:MiB], data[2 * MiB: 3 * MiB]]))
            np.testing.assert_array_equal(slab[:MiB], data[MiB: 2 * MiB])
            st = eng.stats()
            assert st["ops_submitted"] == 24 and st["cached_bytes"] == 0
            assert st["ops_fixed"] == st["ops_submitted"]
            assert st["engine_fixed_buf_ratio"] == 1.0
            assert st["media_bytes"] == 3 * MiB and st["ext_buffers"] == 1
            eng.unregister_dest(slab)
            assert eng.stats()["ext_buffers"] == 0
        finally:
            eng.close()


# each engine flag of StromConfig away from its default, and what the
# engine's stats must then report
KNOBS = {
    "sqpoll": (dict(sqpoll=True), dict(sqpoll=True)),
    "coop_taskrun_off": (dict(coop_taskrun=False), dict(coop_taskrun=False)),
    "register_buffers_off": (dict(register_buffers=False),
                             dict(fixed_buffers=False, ops_fixed=0)),
    "mlock_off": (dict(mlock=False), dict(mlocked=False)),
    "residency_hybrid_off": (dict(residency_hybrid=False),
                             dict(cached_bytes=0, media_bytes=6 * MiB)),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_engine_flags_match_reference(uring, files, knob):
    """A gather read cold and then warm into a slab offered to the ring,
    under one engine flag changed: the same bytes, flags and routes on
    both engines. With the residency hybrid on, the warm pass goes through
    the buffered fd; with it off, both passes go O_DIRECT to the device."""
    kw, expect = KNOBS[knob]
    path, data = files[0]
    plan = [(0, 0, 2 * MiB), (3 * MiB, 2 * MiB, MiB)]
    want = np.concatenate([data[:2 * MiB], data[3 * MiB: 4 * MiB]])
    tp, jp = pair(**kw)
    try:
        for eng in (tp, jp):
            drop_cache(path)
            fi = eng.register_file(path)
            slab = alloc_aligned(3 * MiB)
            eng.register_dest(slab)
            for _ in ("cold", "warm"):
                slab[:] = 0
                assert eng.read_vectored([(fi, *s) for s in plan], slab) == \
                    3 * MiB
                np.testing.assert_array_equal(slab, want)
                with open(path, "rb") as f:    # warm the page cache
                    f.read()
            eng.unregister_dest(slab)
        ts, js = tp.stats(), jp.stats()
        for key in ("sqpoll", "coop_taskrun", "fixed_buffers", "mlocked",
                    "sparse_table", "ops_submitted", "ops_fixed", "bytes_read",
                    "cached_bytes", "media_bytes", "sqpoll_wakeup_errno"):
            assert ts[key] == js[key], key
        assert {k: ts[k] for k in expect} == expect
        if knob != "residency_hybrid_off":
            assert ts["cached_bytes"] == ts["media_bytes"] == 3 * MiB
    finally:
        tp.close()
        jp.close()


@pytest.mark.parametrize("engine,rings,want", [
    ("auto", 1, "uring"), ("uring", 1, "uring"), ("python", 1, "python"),
    ("auto", 2, "multi"), ("python", 2, "python")])
def test_make_engine_picks_the_reference_class(uring, engine, rings, want):
    kw = dict(engine=engine, engine_rings=rings, **SMALL)
    tp, jp = make_engine(StromConfig(**kw)), j_make_engine(JConfig(**kw))
    try:
        assert type(tp).__name__ == type(jp).__name__
        assert tp.stats()["engine"] == jp.stats()["engine"] == want
        assert isinstance(tp, {"uring": ue.UringEngine, "multi": MultiRingEngine,
                               "python": PythonEngine}[want])
    finally:
        tp.close()
        jp.close()


class _NoRing:
    """A loaded library whose sc_create fails as a refused io_uring_setup
    does (NULL, errno EPERM)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def sc_create(self, *args):
        ctypes.set_errno(errno.EPERM)
        return None


def test_refused_ring_uring_raises_auto_gives_python(uring, monkeypatch):
    for mod in (ue, j_ue):
        lib = mod._load_lib()
        monkeypatch.setattr(mod, "_load_lib", lambda *a, lib=lib: _NoRing(lib))
    for mk, cfg, exc in ((make_engine, StromConfig, EngineError),
                         (j_make_engine, JConfig, JEngineError)):
        with pytest.raises(exc) as info:
            mk(cfg(engine="uring", **SMALL))
        assert info.value.errno == errno.EPERM
        with pytest.raises(exc):
            mk(cfg(engine="uring", engine_rings=2, **SMALL))
        eng = mk(cfg(engine="auto", **SMALL))
        try:
            assert eng.stats()["engine"] == "python"
        finally:
            eng.close()
    assert not ue.uring_available()
    assert ue.create_errno == errno.EPERM and "EPERM" in ue.unavailable_reason


def test_multi_ring_gather_matches_reference(uring, files):
    """A two-file gather fans out per file (file i → ring i mod N); a
    one-file gather takes one ring, round-robin."""
    paths = [p for p, _ in files]
    steps = PLANS["two_files"]
    size = max(do + ln for _, _, do, ln in steps)
    tp = MultiRingEngine(StromConfig(engine_rings=2, **SMALL))
    jp = JMulti(JConfig(engine_rings=2, **SMALL))
    try:
        assert tp.concurrent_gathers and tp.stats()["rings"] == 2
        got_n, got = gather(tp, paths, steps, None, size)
        ref_n, ref = gather(jp, paths, steps, None, size)
        assert got_n == ref_n and np.array_equal(got, ref)
        rings = [r["bytes_read"] for r in tp.stats()["ring_stats"]]
        assert rings == [r["bytes_read"] for r in jp.stats()["ring_stats"]]
        assert all(b > 0 for b in rings) and sum(rings) == got_n
        before = rings
        for _ in range(2):   # one file: each gather on the next ring
            dest = alloc_aligned(MiB)
            assert tp.read_vectored([(0, 0, 0, MiB)], dest) == MiB
            np.testing.assert_array_equal(dest, files[0][1][:MiB])
        after = [r["bytes_read"] for r in tp.stats()["ring_stats"]]
        assert [a - b for a, b in zip(after, before)] == [MiB, MiB]
        slab = alloc_aligned(MiB)
        assert tp.register_dest(slab) == 0
        assert tp.stats()["ring_stats"][1]["ext_buffers"] == 1
        tp.unregister_dest(slab)
        assert [r["ext_buffers"] for r in tp.stats()["ring_stats"]] == [0, 0]
    finally:
        tp.close()
        jp.close()


@pytest.mark.parametrize("cls", ["_ScCompletion", "_ScStats", "_ScVecSeg",
                                 "_ScRawOp"])
def test_ctypes_layouts_match_reference(cls):
    mine, ref = getattr(ue, cls), getattr(j_ue, cls)
    assert [(n, ctypes.sizeof(t)) for n, t in mine._fields_] == \
        [(n, ctypes.sizeof(t)) for n, t in ref._fields_]
    assert ctypes.sizeof(mine) == ctypes.sizeof(ref)
    for name, _ in mine._fields_:
        assert getattr(mine, name).offset == getattr(ref, name).offset


def test_split_chunks_matches_reference():
    chunks = [(0, 7, 0, 5 * (1 << 31) + 3), (1, 0, 11, 1 << 31), (2, 5, 9, 0)]
    for limit in (1 << 31, 1000):
        small = [c if c[3] < 50_000 else (*c[:3], c[3] % 50_000)
                 for c in chunks] if limit == 1000 else chunks
        assert ue._split_chunks(small, limit) == j_ue._split_chunks(small, limit)
    assert all(c[3] <= 1 << 31 for c in ue._split_chunks(chunks))
    with pytest.raises(ValueError):
        ue._split_chunks([(0, 0, 0, -1)])


def test_config_engine_fields_match_reference(monkeypatch):
    names = ("engine", "mlock", "register_buffers", "coop_taskrun", "sqpoll",
             "residency_hybrid", "engine_rings", "fault_every", "raid_chunk",
             "stripe_window_bytes", "resolved_stripe_window_bytes")
    assert [getattr(StromConfig(), n) for n in names] == \
        [getattr(JConfig(), n) for n in names]
    monkeypatch.setenv("STROM_ENGINE", "python")
    monkeypatch.setenv("STROM_ENGINE_RINGS", "3")
    monkeypatch.setenv("STROM_MLOCK", "0")
    monkeypatch.setenv("STROM_STRIPE_WINDOW_BYTES", "1m")
    got, ref = StromConfig.from_env(), JConfig.from_env()
    assert [getattr(got, n) for n in names] == [getattr(ref, n) for n in names]
    assert (got.engine, got.engine_rings, got.mlock) == ("python", 3, False)
    for bad in (dict(engine_rings=0), dict(stripe_window_bytes=-2)):
        with pytest.raises(ValueError):
            StromConfig(**bad)
        with pytest.raises(ValueError):
            JConfig(**bad)


class _FakeCudart:
    def __init__(self, log):
        self.log = log

    def cudaHostRegister(self, addr, n, flags):
        self.log.append(("cuda+", addr))
        return 0

    def cudaHostUnregister(self, addr):
        self.log.append(("cuda-", addr))
        return 0


def test_pool_slabs_join_the_ring_after_cuda_and_leave_before(uring,
                                                              monkeypatch):
    """Each pool slab is registered with CUDA, then with the ring; leaving
    the pool (past the cap, at close, or released after close) it leaves
    the ring first and CUDA second. The ring's 64 external slots full, a
    65th slab is refused and counted."""
    log = []
    monkeypatch.setattr(torch.cuda, "cudart", lambda: _FakeCudart(log))
    ctx = StromContext(StromConfig(engine="uring", slab_pool_bytes=2 * MiB,
                                   **SMALL))
    eng, pool = ctx.engine, ctx._slab_pool
    ring = []
    for name, tag in (("register_dest", "ring+"), ("unregister_dest", "ring-")):
        def hook(arr, real=getattr(eng, name), tag=tag):
            ring.append((tag, arr.__array_interface__["data"][0]))
            log.append(ring[-1])
            return real(arr)
        monkeypatch.setattr(eng, name, hook)
    pool._on_alloc, pool._on_free = eng.register_dest, eng.unregister_dest
    try:
        a, b = pool.acquire(MiB), pool.acquire(3 * MiB)
        addr_a, addr_b = (x.__array_interface__["data"][0] for x in (a, b))
        assert log == [("cuda+", addr_a), ("ring+", addr_a),
                       ("cuda+", addr_b), ("ring+", addr_b)]
        assert eng.stats()["ext_buffers"] == 2
        pool.release(a)                  # cached: stays registered
        pool.release(b)                  # past the 2 MiB cap: leaves
        assert log[4:] == [("ring-", addr_b), ("cuda-", addr_b)]
        many = [pool.acquire(4096 * (i + 2)) for i in range(64)]
        st = ctx.stats()["engine"]
        assert st["ext_buffers"] == 64 and st["dest_refused"] == 1
        late = many.pop()
        pool.release(many.pop())
        del log[:]
        ctx.close()                      # engine first, then the pool
        assert log[0][0] == "ring-" and log[1] == ("cuda-", log[0][1])
        assert [e[0] for e in log[::2]] == ["ring-"] * (len(log) // 2)
        # slabs still out leave at close too, ring first: none stays
        # registered past the pool
        addr = late.__array_interface__["data"][0]
        i = log.index(("ring-", addr))
        assert log[i + 1] == ("cuda-", addr)
        del log[:]
        pool.release(late)               # released after close: nothing left
        assert log == []
        for x in many:
            pool.release(x)
    finally:
        ctx.close()


_BUILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("b", sys.argv[1])
b = importlib.util.module_from_spec(spec)
spec.loader.exec_module(b)
print(b.ensure_built(sys.argv[2]), b.build_seconds is not None)
"""


def test_two_processes_build_one_library(tmp_path):
    """Two processes building into one empty directory at once: one
    compiles, the other waits on the lock and takes its library; no
    temporary file is left and the library loads."""
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, core_build.__file__,
                               build_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths, built = zip(*(o.split() for o, _ in outs))
    assert paths[0] == paths[1] == core_build.lib_path(build_dir)
    assert sorted(built) == ["False", "True"]
    libs = [n for n in os.listdir(build_dir)
            if not n.endswith((".lock", ".jpeg"))]
    assert libs == [os.path.basename(paths[0])]
    # beside it, the marker of the libjpeg-turbo probe it was built with
    assert core_build.built_with_jpeg(paths[0]) is core_build.jpeg_probe()
    lib = ctypes.CDLL(paths[0])
    assert lib.sc_create and lib.sc_read_vectored
    assert lib.sc_jpeg_available() == int(core_build.jpeg_probe())


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(core_build, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="failed to build strom_core"):
        core_build.ensure_built(str(tmp_path / "build"))
    assert not any(".tmp." in n for n in os.listdir(tmp_path / "build"))


def test_stats_match_reference_keys(uring):
    tp, jp = pair()
    try:
        missing = set(jp.stats()) - set(tp.stats())
        # the write path's counters included
        assert missing == set()
    finally:
        tp.close()
        jp.close()


@pytest.mark.parametrize("engine", ["python", "uring"])
@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("offset,length", [
    (0, 3 * MiB),                      # whole blocks
    (4096, 3 * MiB - 8192),            # a short tail block
    (3 * MiB - 100_000, 300_000),      # past EOF: short at the end
    (5 * MiB, 4096),                   # wholly past EOF
])
def test_read_into_matches_reference(tmp_path, engine, direct, offset,
                                     length):
    """``read_into`` (through the staging pool) and ``read_into_direct``
    (straight into the dest) give the reference's bytes and return counts,
    short at EOF, on the preadv pool and the io_uring engine."""
    if engine == "uring" and not ue.uring_available():
        pytest.skip(f"io_uring unavailable: {ue.unavailable_reason}")
    path = str(tmp_path / "r.bin")
    data = np.random.default_rng(9).integers(0, 256, 3 * MiB,
                                             dtype=np.uint8)
    write_cold(path, data)
    kw = dict(engine=engine, block_size=256 * 1024, **SMALL)
    got = {}
    for name, eng in (("torch", make_engine(StromConfig(**kw))),
                      ("jax", j_make_engine(JConfig(**kw)))):
        try:
            fi = eng.register_file(path)
            dest = alloc_aligned(length + 4096)
            dest[:] = 0xAB
            if direct:
                n = eng.read_into_direct(fi, offset, length, dest)
            else:
                n = eng.read_into(fi, offset, length, dest, out_offset=4096
                                  if length + 4096 <= dest.nbytes else 0)
            got[name] = (n, dest.copy())
        finally:
            eng.close()
        drop_cache(path)
    assert got["torch"][0] == got["jax"][0]
    np.testing.assert_array_equal(got["torch"][1], got["jax"][1])
    n = got["torch"][0]
    assert n == max(0, min(length, data.size - offset))


def test_read_into_raises_engine_error_on_a_failed_op(tmp_path):
    """An op that fails (its file unregistered under it: EBADF) raises
    EngineError from ``read_into`` and ``read_into_direct``, as the
    reference's engine does."""
    path = str(tmp_path / "e.bin")
    write_cold(path, np.zeros(1 * MiB, np.uint8))
    for mk, cfg, err in ((make_engine, StromConfig, EngineError),
                         (j_make_engine, JConfig, JEngineError)):
        eng = mk(cfg(engine="python", **SMALL))
        try:
            fi = eng.register_file(path)
            eng.unregister_file(fi)
            with pytest.raises(err):
                eng.read_into_direct(fi, 0, 1 * MiB, alloc_aligned(1 * MiB))
            with pytest.raises(err):
                eng.read_into(fi, 0, 1 * MiB, np.zeros(1 * MiB, np.uint8))
        finally:
            eng.close()
