"""The port's hot cache, readahead and epoch-aware ``peek`` against the
reference's (``strom/delivery/hotcache.py``, ``strom/pipelines/sampler.py``).

- A hypothesis-generated sequence of admit, lookup, view, unpin,
  invalidate, partition and clear operations runs through both
  ``HotCache`` classes: the same hits and misses, the same bytes, the same
  LRU (eviction) order and the same ``stats()`` after every step.
- Context parity: ``pread``, ``memcpy_ssd2host`` and ``stream_segments``
  with the cache on (both admission policies) give the bytes of the cache
  off and of the JAX package's context; a repeat streamed gather reports
  its cached ranges as instant completions.
- Readahead and ``warm`` as tests/test_hotcache.py checks them, the
  sampler's ``peek`` against the reference's, and the predecoded pipeline
  over three epochs with the cache and readahead on, against the cache off
  and the reference's pipeline, byte for byte.
"""

import json
import time

import hypothesis.strategies as st
import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.delivery.extents import ExtentList as JExtentList
from strom.delivery.hotcache import HotCache as JHotCache
from strom.pipelines import make_predecoded_vision_pipeline as j_predecoded
from strom.pipelines.sampler import EpochShuffleSampler as JSampler
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.extents import ExtentList
from strom_torch.delivery.hotcache import HotCache, Readahead
from strom_torch.delivery.shard import Segment
from strom_torch.pipelines.sampler import EpochShuffleSampler
from strom_torch.pipelines.vision import make_predecoded_vision_pipeline

KiB = 1024
MiB = 1024 * KiB


# ------------------------------------------------------- the LRU itself
KEYS = ("a", "b", ("jpegdec", "a", 0, 4096, "rgb8"))
TENANTS = (None, "t0", "t1")
SPAN = 64 * KiB
_DATA = {k: np.random.default_rng(i).integers(0, 256, SPAN, dtype=np.uint8)
         for i, k in enumerate(KEYS)}

_range = st.tuples(st.integers(0, SPAN - 1), st.integers(1, 24 * KiB)).map(
    lambda t: (t[0], min(SPAN, t[0] + t[1])))
OPS = st.one_of(
    st.tuples(st.just("admit"), st.sampled_from(KEYS), _range, st.booleans(),
              st.sampled_from(TENANTS)),
    st.tuples(st.just("lookup"), st.sampled_from(KEYS), _range),
    st.tuples(st.just("view"), st.sampled_from(KEYS), _range),
    st.tuples(st.just("unpin"), st.integers(0, 7)),
    st.tuples(st.just("invalidate"), st.sampled_from(("a", "b"))),
    st.tuples(st.just("partition"), st.sampled_from(("t0", "t1")),
              st.sampled_from((0, 8 * KiB, 32 * KiB))),
    st.tuples(st.just("clear")),
)


def _apply(cache, op, pins: list):
    """One operation; returns what a caller observes of it."""
    kind = op[0]
    if kind == "admit":
        _, key, (lo, hi), force, tenant = op
        return cache.admit(key, lo, hi, _DATA[key][lo:hi], force=force,
                           tenant=tenant)
    if kind == "lookup":
        _, key, (lo, hi) = op
        hits, misses, pinned = cache.lookup(key, lo, hi)
        pins.append(pinned)
        return ([(s, t, bytes(v)) for s, t, v in hits], misses)
    if kind == "view":
        _, key, (lo, hi) = op
        got = cache.view(key, lo, hi)
        if got is None:
            return None
        pins.append([got[1]])
        return bytes(got[0])
    if kind == "unpin":
        if not pins:
            return None
        cache.unpin(pins.pop(op[1] % len(pins)))
        return len(pins)
    if kind == "invalidate":
        return cache.invalidate(op[1])
    if kind == "partition":
        cache.set_partition(op[1], op[2])
        return cache.partitions()
    cache.clear()
    return None


def _lru(cache) -> list:
    return [(e.skey, e.lo, e.hi, e.refs, e.tenant)
            for e in cache._lru.values()]


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(admit=st.sampled_from(("second_touch", "always")),
       ops=st.lists(OPS, min_size=1, max_size=40))
def test_operation_sequences_match_reference(admit, ops):
    want, got = (JHotCache(48 * KiB, admit=admit, block_bytes=8 * KiB),
                 HotCache(48 * KiB, admit=admit, block_bytes=8 * KiB))
    wpins: list = []
    gpins: list = []
    for op in ops:
        assert _apply(got, op, gpins) == _apply(want, op, wpins), op
        assert _lru(got) == _lru(want), op
        assert got.stats() == want.stats(), op
        assert got.manifest() == want.manifest()
        assert got.bytes <= got.max_bytes
    for p in gpins:
        got.unpin(p)
    assert all(e.refs == 0 for e in got._lru.values())


def test_pinned_entry_frees_on_last_unpin():
    """An entry evicted under byte pressure while pinned keeps its buffer
    until the last unpin; the view stays readable meanwhile."""
    hc = HotCache(8 * KiB, admit="always")
    data = _DATA["a"]
    assert hc.admit("a", 0, 8 * KiB, data[: 8 * KiB]) == 8 * KiB
    view, entry = hc.view("a", 0, 4 * KiB)
    hc.invalidate("a")
    assert hc.entries == 0 and entry.dead and entry.buf is not None
    assert bytes(view) == bytes(data[: 4 * KiB])
    hc.unpin([entry])
    assert entry.buf is None


# ----------------------------------------------------- context parity
def _cfg(cls, **kw):
    kw.setdefault("engine", "python")
    kw.setdefault("queue_depth", 8)
    kw.setdefault("num_buffers", 16)
    return cls(**kw)


@pytest.fixture()
def two_files(tmp_path):
    rng = np.random.default_rng(11)
    out = []
    for name, n in (("data.bin", 4 * MiB + 777), ("second.bin", MiB)):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        path = str(tmp_path / name)
        data.tofile(path)
        out.append((path, data))
    return out


@pytest.fixture(params=["always", "second_touch"])
def ctxs(request):
    # each context counts through a scope of its own (the registry is
    # process-wide): its scoped series are this context's alone
    tag = f"{request.node.name}-{id(request)}"
    on = StromContext(_cfg(StromConfig, hot_cache_bytes=16 * MiB,
                           hot_cache_admit=request.param),
                      scope={"test_ctx": f"on-{tag}"})
    off = StromContext(_cfg(StromConfig), scope={"test_ctx": f"off-{tag}"})
    ref = JContext(_cfg(JConfig))
    yield on, off, ref
    for c in (on, off, ref):
        c.close()


def test_pread_and_ssd2host_parity(ctxs, two_files):
    """Three rounds (second touch admits in the second, serves in the
    third): every read equals the cache-off port's and the reference's."""
    on, off, ref = ctxs
    (path, data), (p2, data2) = two_files
    el = [(path, 0, 256 * KiB), (p2, 0, 256 * KiB), (path, 3 * MiB, 5000)]
    el2 = [(p2, 0, 128 * KiB), (path, 64 * KiB, 64 * KiB)]
    for _ in range(3):
        for extents in (el, el2):
            a = on.pread(ExtentList(extents))
            b = off.pread(ExtentList(extents))
            c = np.asarray(memoryview(ref.pread(JExtentList(extents))))
            assert np.array_equal(a, b) and np.array_equal(a, c)
        a = on.memcpy_ssd2host(path, offset=4096, length=MiB)
        b = off.memcpy_ssd2host(path, offset=4096, length=MiB)
        c = ref.memcpy_ssd2host(path, offset=4096, length=MiB)
        assert np.array_equal(a, b) and np.array_equal(a, c)
        assert np.array_equal(a, data[4096: 4096 + MiB])
        for ctx in (on, off):
            assert np.array_equal(ctx.pread(path, 100, 9000), data[100: 9100])
    st_ = on.stats()["cache"]
    assert st_["cache_hit_bytes"] > 0 and st_["cache_admitted_bytes"] > 0
    # bytes delivered count cache-served bytes too
    assert on.scope.counter("ssd2gpu_bytes").value \
        == off.scope.counter("ssd2gpu_bytes").value > 0


def _stream(ctx, el):
    dest = ctx.alloc_read_buffer(el, el.size)
    g = ctx.stream_segments(el, [Segment(0, 0, el.size)], dest)
    ranges = []
    while not g.done:
        ranges.extend(g.poll(min_completions=1, timeout_s=0.05))
    assert g.finish() == el.size
    g.close()
    pos = 0
    for lo, hi in sorted(ranges):
        assert lo == pos and hi > lo
        pos = hi
    assert pos == el.size
    return dest, g.instant_bytes


def test_stream_segments_cache_instants(ctxs, two_files):
    """Repeat streamed gathers: the cached ranges surface as instant
    completions, every dest byte exactly once, bytes as the reference's
    pread of the same extents."""
    on, off, ref = ctxs
    (path, data), (p2, _) = two_files
    extents = [(path, 8192, 300 * KiB), (p2, 4096, 100 * KiB),
               (path, 2 * MiB, 64 * KiB)]
    want = np.asarray(memoryview(ref.pread(JExtentList(extents))))
    instants = []
    for _ in range(3):
        got, inst = _stream(on, ExtentList(extents))
        assert np.array_equal(got, want)
        assert np.array_equal(_stream(off, ExtentList(extents))[0], want)
        instants.append(inst)
    size = ExtentList(extents).size
    assert instants[-1] == size     # the third gather is all cache
    assert on.scope.counter("stream_instant_bytes").value == sum(instants)
    assert off.scope.counter("stream_instant_bytes").value == 0


def test_memcpy_ssd2gpu_cpu_target_served(two_files):
    """The delivery entry point on a CPU target, streamed and not, with
    the cache serving a repeat read."""
    (path, data), _ = two_files
    ctx = StromContext(_cfg(StromConfig, hot_cache_bytes=16 * MiB,
                            hot_cache_admit="always",
                            overlap_chunk_bytes=MiB, overlap_min_bytes=2 * MiB))
    try:
        streamed0 = ctx.stats()["context"]["streamed_transfers"]
        for _ in range(2):
            small = ctx.memcpy_ssd2gpu(path, length=MiB, device="cpu")
            big = ctx.memcpy_ssd2gpu(path, length=3 * MiB, device="cpu")
            assert torch.equal(small, torch.from_numpy(data[:MiB]))
            assert torch.equal(big, torch.from_numpy(data[: 3 * MiB]))
        st_ = ctx.stats()
        assert st_["context"]["streamed_transfers"] - streamed0 == 2
        assert st_["cache"]["cache_hit_bytes"] >= 4 * MiB
    finally:
        ctx.close()


# --------------------------------------------------------- readahead
@pytest.fixture()
def ctx_on():
    c = StromContext(_cfg(StromConfig, hot_cache_bytes=16 * MiB,
                          hot_cache_admit="always"))
    yield c
    c.close()


def test_warm_yields_to_demand(ctx_on, two_files):
    (path, _), _ = two_files
    with ctx_on._demand_gate():
        assert ctx_on.warm(path, [Segment(0, 0, MiB)]) == 0
    st_ = ctx_on.stats()["cache"]
    assert st_["cache_readahead_yields"] == 1
    assert st_["cache_readahead_bytes"] == 0


def test_warm_skips_cached_and_admits_misses(ctx_on, two_files):
    (path, data), _ = two_files
    ctx_on.pread(path, 0, MiB)
    assert ctx_on.warm(path, [Segment(0, 0, 2 * MiB)]) == MiB
    miss0 = ctx_on.stats()["cache"]["cache_miss_bytes"]
    assert np.array_equal(ctx_on.pread(path, 0, 2 * MiB), data[: 2 * MiB])
    assert ctx_on.stats()["cache"]["cache_miss_bytes"] == miss0


def _wait_for(pred, what):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    pytest.fail(what)


def test_readahead_thread_warms_window(ctx_on, two_files):
    (path, data), _ = two_files
    ra = Readahead(ctx_on, lambda n: [(path, [Segment(0, 0, MiB)], 0)],
                   interval_s=0.005)
    try:
        _wait_for(lambda: ctx_on.stats()["cache"]["cache_readahead_bytes"]
                  >= MiB, "readahead never warmed the window")
    finally:
        ra.close()
    miss0 = ctx_on.stats()["cache"]["cache_miss_bytes"]
    assert np.array_equal(ctx_on.pread(path, 0, MiB), data[:MiB])
    assert ctx_on.stats()["cache"]["cache_miss_bytes"] == miss0


def test_readahead_counts_a_broken_window(ctx_on):
    def boom(n):
        raise RuntimeError("window_fn broke")

    ra = Readahead(ctx_on, boom, interval_s=0.001)
    try:
        _wait_for(lambda: ctx_on.stats()["cache"]["cache_readahead_errors"],
                  "readahead error never counted")
    finally:
        ra.close()


def test_disabled_cache_serves_and_warms_nothing(ctx_on, two_files):
    (path, data), _ = two_files
    ctx_on.hot_cache.enabled = False
    assert np.array_equal(ctx_on.pread(path, 0, MiB), data[:MiB])
    st_ = ctx_on.stats()["cache"]
    assert st_["cache_hit_bytes"] == st_["cache_miss_bytes"] == 0
    assert st_["cache_admitted_bytes"] == 0
    assert ctx_on.warm(path, [Segment(0, 0, MiB)]) == 0
    ctx_on.hot_cache.enabled = True
    ctx_on.pread(path, 0, MiB)
    assert ctx_on.stats()["cache"]["cache_admitted_bytes"] == MiB


@pytest.mark.parametrize("n,batch,consumed,window", [
    (12, 4, 1, 4), (12, 4, 0, 7), (10, 3, 2, 5), (9, 9, 3, 2)])
def test_peek_matches_reference(n, batch, consumed, window):
    """The same upcoming window as the reference's peek, across the epoch
    boundary, and the batches the sampler then yields; the cursor stays."""
    t, j = EpochShuffleSampler(n, batch, seed=3), JSampler(n, batch, seed=3)
    ti, ji = iter(t), iter(j)
    for _ in range(consumed):
        next(ti), next(ji)
    state = (t.state.epoch, t.state.batch_in_epoch)
    got, want = t.peek(window), j.peek(window)
    assert (t.state.epoch, t.state.batch_in_epoch) == state
    assert len(got) == window
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    for g in got:
        assert np.array_equal(next(ti), g)


# ------------------------------------------------- pipeline parity
@pytest.fixture(scope="module")
def pdec_shard(tmp_path_factory):
    td = tmp_path_factory.mktemp("hc_pdec")
    n, size = 24, 16
    raw = np.random.default_rng(3).integers(0, 256, (n, size, size, 3),
                                            dtype=np.uint8)
    path = str(td / "imgs.pdec")
    raw.tofile(path)
    np.save(path + ".labels.npy", np.arange(n, dtype=np.int32) % 7)
    with open(path + ".meta.json", "w") as f:
        json.dump({"image_size": size, "n": n}, f)
    return path, raw


@pytest.mark.parametrize("admit", ["second_touch", "always"])
def test_predecoded_epochs_bit_identical(pdec_shard, admit):
    """Three epochs with the cache and readahead on: batches equal the
    cache-off port's and the reference pipeline's; the later epochs are
    served from the cache."""
    path, raw = pdec_shard
    bpe = raw.shape[0] // 8

    def port(ctx):
        with make_predecoded_vision_pipeline(ctx, [path], batch=8,
                                             image_size=16, device="cpu",
                                             seed=11) as pipe:
            return [tuple(t.numpy().copy() for t in next(pipe))
                    for _ in range(3 * bpe)]

    on = StromContext(_cfg(StromConfig, hot_cache_bytes=8 * MiB,
                           hot_cache_admit=admit,
                           readahead_window_batches=2))
    off = StromContext(_cfg(StromConfig))
    ref = JContext(_cfg(JConfig))
    try:
        got, plain = port(on), port(off)
        mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        with j_predecoded(ref, [path], batch=8, image_size=16, seed=11,
                          sharding=NamedSharding(mesh, P("dp"))) as pipe:
            want = [tuple(np.asarray(t) for t in next(pipe))
                    for _ in range(3 * bpe)]
        for (gi, gl), (pi, pl), (wi, wl) in zip(got, plain, want):
            assert np.array_equal(gi, pi) and np.array_equal(gi, wi)
            assert np.array_equal(gl, pl) and np.array_equal(gl, wl)
        assert on.stats()["cache"]["cache_hit_bytes"] > 0
    finally:
        for c in (on, off, ref):
            c.close()
