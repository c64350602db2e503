"""The PyTorch port's delivery path against the JAX package's on the CPU:
``memcpy_ssd2gpu(device="cpu")`` returns the file's bytes, and the same
bytes as ``np.asarray(strom ... memcpy_ssd2tpu(...))``, for a whole file, a
byte range viewed as a typed array, an ExtentList, a streamed transfer and
an async one; and the two Llama pipelines yield identical batches for the
same seed and shards, across an epoch boundary and after ``restore``."""

import dataclasses
import os

import jax
import numpy as np
import pytest
from jax.sharding import SingleDeviceSharding

import strom_torch
from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.delivery.core import split_segments as j_split_segments
from strom.delivery.extents import Extent as JExtent
from strom.delivery.extents import ExtentList as JExtentList
from strom.delivery.shard import Segment as JSegment
from strom.pipelines import make_llama_pipeline as j_make_llama_pipeline
from strom.pipelines.sampler import SamplerState as JSamplerState
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext, split_segments
from strom_torch.delivery.extents import Extent, ExtentList
from strom_torch.delivery.shard import Segment
from strom_torch.formats.rawbin import TokenShardSet, write_token_shard
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline
from strom_torch.pipelines.sampler import SamplerState

MiB = 1024 * 1024
# tiny streaming thresholds, so a 4 MiB file takes the streamed path
STREAM = dict(overlap_chunk_bytes=1 * MiB, overlap_min_bytes=2 * MiB)


def skip_without_uring():
    from strom_torch.engine import uring_engine

    if not uring_engine.uring_available():
        pytest.skip(f"io_uring unavailable: {uring_engine.unavailable_reason}")


@pytest.fixture(params=["python", "uring"])
def contexts(request):
    """(port context, JAX context) with one config: the engine of the
    parameter (uring skips where the kernel refuses a ring), small queues;
    *stream* picks the tiny streaming thresholds."""
    engine = request.param
    if engine == "uring":
        skip_without_uring()
    made = []

    def make(stream: bool = False):
        kw = dict(engine=engine, queue_depth=8, num_buffers=8,
                  **(STREAM if stream else {}))
        pair = StromContext(StromConfig(**kw)), JContext(JConfig(**kw))
        assert pair[0].engine.name == pair[1].engine.name == engine
        made.extend(pair)
        return pair

    yield make
    for ctx in made:
        ctx.close()


def test_whole_file(contexts, data_file):
    path, data = data_file
    tctx, jctx = contexts()
    got = tctx.memcpy_ssd2gpu(path, device="cpu")
    assert got.device.type == "cpu" and got.dtype.itemsize == 1
    np.testing.assert_array_equal(got.numpy(), data)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jctx.memcpy_ssd2tpu(path)))
    assert tctx.stats()["streamed_transfers"] == 0


def test_range_as_typed_array(contexts, data_file):
    path, data = data_file
    tctx, jctx = contexts()
    kw = dict(offset=8192, shape=(256, 1024), dtype=np.int32)
    got = tctx.memcpy_ssd2gpu(path, device="cpu", **kw).numpy()
    want = data[8192: 8192 + MiB].view(np.int32).reshape(256, 1024)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jctx.memcpy_ssd2tpu(path, **kw)))


def test_extent_list(contexts, data_file):
    path, data = data_file
    tctx, jctx = contexts()
    spans = [(100, 5000), (9000, 3000), (2 * MiB + 17, 70_001), (0, 4096)]
    got = tctx.memcpy_ssd2gpu(ExtentList([Extent(path, o, n) for o, n in spans]),
                              device="cpu").numpy()
    want = np.concatenate([data[o: o + n] for o, n in spans])
    np.testing.assert_array_equal(got, want)
    jgot = jctx.memcpy_ssd2tpu(JExtentList([JExtent(path, o, n) for o, n in spans]))
    np.testing.assert_array_equal(got, np.asarray(jgot))


def test_streamed(contexts, data_file):
    path, data = data_file
    tctx, jctx = contexts(stream=True)
    got = tctx.memcpy_ssd2gpu(path, device="cpu").numpy()
    assert tctx.stats()["streamed_transfers"] == 1
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, np.asarray(jctx.memcpy_ssd2tpu(path)))
    # a streamed ExtentList: pieces cut across extents
    spans = [(4096, 3 * MiB), (7, MiB + 5)]
    el = ExtentList([Extent(path, o, n) for o, n in spans])
    got = tctx.memcpy_ssd2gpu(el, device="cpu").numpy()
    assert tctx.stats()["streamed_transfers"] == 2
    np.testing.assert_array_equal(
        got, np.concatenate([data[o: o + n] for o, n in spans]))


@pytest.mark.parametrize("stream", [False, True])
def test_async(contexts, data_file, stream):
    path, data = data_file
    tctx, jctx = contexts(stream=stream)
    kw = dict(shape=(MiB,), dtype=np.uint32)
    h = tctx.memcpy_ssd2gpu(path, device="cpu", async_=True, **kw)
    assert isinstance(h, strom_torch.DMAHandle)
    got = strom_torch.memcpy_wait(h, timeout=60).numpy()
    np.testing.assert_array_equal(got, data[: 4 * MiB].view(np.uint32))
    jh = jctx.memcpy_ssd2tpu(path, async_=True, **kw)
    np.testing.assert_array_equal(got, np.asarray(jh.result(60)))


def test_module_level_api(data_file):
    path, data = data_file
    strom_torch.init(StromConfig(queue_depth=4, num_buffers=4))
    try:
        got = strom_torch.memcpy_ssd2gpu(path, length=65536, device="cpu")
        np.testing.assert_array_equal(got.numpy(), data[:65536])
        st = strom_torch.stats()
        assert st["transfers"] == 1 and st["ssd2gpu_bytes"] == 65536
        # engine="auto" (the default) picks what the reference picks
        want = JContext(JConfig(queue_depth=4, num_buffers=4))
        try:
            assert st["engine"]["engine"] == want.engine.name
        finally:
            want.close()
    finally:
        strom_torch.close()
    # as the reference's: stats() with no context creates a fresh one
    try:
        assert strom_torch.stats()["transfers"] == 0
    finally:
        strom_torch.close()


def test_read_past_eof_raises(contexts, data_file):
    from strom_torch.engine import EngineError

    path, data = data_file
    tctx, _ = contexts()
    with pytest.raises(EngineError):
        tctx.memcpy_ssd2gpu(path, offset=len(data) - 100, length=4096,
                            device="cpu")
    with pytest.raises(ValueError, match="multiple of dtype"):
        tctx.memcpy_ssd2gpu(path, length=6, dtype=np.int32, device="cpu")


def test_closed_context_refuses(data_file):
    path, _ = data_file
    ctx = StromContext(StromConfig(queue_depth=4, num_buffers=4))
    ctx.close()
    with pytest.raises(RuntimeError, match="closed"):
        ctx.memcpy_ssd2gpu(path, device="cpu")


def _flat(pieces):
    return [(b, n, [(x.file_offset, x.dest_offset, x.length) for x in p])
            for b, n, p in pieces]


def test_split_segments_matches_reference():
    segs = [(50 * MiB, 2 * MiB, 2 * MiB), (10 * MiB, 0, 2 * MiB),
            (30 * MiB, 4 * MiB, 2 * MiB)]
    for chunk in (MiB, 3 * MiB, 16 * MiB):
        got = split_segments([Segment(*s) for s in segs], chunk)
        want = j_split_segments([JSegment(*s) for s in segs], chunk)
        assert _flat(got) == _flat(want)


def test_config_env_overrides(monkeypatch):
    monkeypatch.setenv("STROM_QUEUE_DEPTH", "7")
    monkeypatch.setenv("STROM_OVERLAP_CHUNK_BYTES", "4m")
    monkeypatch.setenv("STROM_O_DIRECT", "0")
    cfg = StromConfig.from_env(num_buffers=3)
    assert (cfg.queue_depth, cfg.overlap_chunk_bytes, cfg.o_direct,
            cfg.num_buffers) == (7, 4 * MiB, False, 3)
    jcfg = JConfig.from_env(num_buffers=3)
    assert (jcfg.queue_depth, jcfg.overlap_chunk_bytes, jcfg.o_direct) == \
        (cfg.queue_depth, cfg.overlap_chunk_bytes, cfg.o_direct)
    assert StromConfig().engine == JConfig().engine == "auto"
    for bad in ("io_uring", "multi", ""):
        with pytest.raises(ValueError, match="unknown engine"):
            StromConfig(engine=bad)
        with pytest.raises(ValueError, match="unknown engine"):
            JConfig(engine=bad)


# --------------------------------------------------------------- pipelines
SEQ = 16           # tokens per record = SEQ + 1


@pytest.fixture()
def token_shards(tmp_path):
    """Two shards of 12 and 9 records, a ragged tail on the second."""
    rng = np.random.default_rng(11)
    paths = []
    for i, n in enumerate((12 * (SEQ + 1), 9 * (SEQ + 1) + 5)):
        p = str(tmp_path / f"tok{i}.bin")
        write_token_shard(p, rng.integers(0, 1000, n, dtype=np.int32))
        paths.append(p)
    return paths


def test_token_shard_set_locates_records(token_shards):
    shards = TokenShardSet(tuple(token_shards), record_tokens=SEQ + 1)
    assert shards.num_records == 21
    assert shards.locate(12) == (token_shards[1], 0)
    el = shards.extents([3, 4, 5, 13])
    assert [(e.path, e.offset, e.length) for e in el.extents] == [
        (token_shards[0], 3 * 68, 3 * 68), (token_shards[1], 68, 68)]


def test_pipelines_yield_identical_batches(token_shards):
    """Same seed and shards: identical batches across the epoch boundary
    (21 records, batch 4: 5 batches an epoch), and again after both are
    restored to the same mid-epoch state."""
    tctx = StromContext(StromConfig(queue_depth=4, num_buffers=4))
    jctx = JContext(JConfig(engine="python", queue_depth=4, num_buffers=4))
    sharding = SingleDeviceSharding(jax.devices()[0])
    kw = dict(batch=4, seq_len=SEQ, seed=3)
    try:
        with make_llama_pipeline(tctx, token_shards, device="cpu", **kw) as tp, \
                j_make_llama_pipeline(jctx, token_shards, sharding=sharding,
                                      **kw) as jp:
            assert tp.sampler.batches_per_epoch == 5
            for _ in range(12):
                got, want = next(tp), np.asarray(next(jp))
                assert got.shape == (4, SEQ + 1)
                np.testing.assert_array_equal(got.numpy(), want)
            assert tp.state() == SamplerState(epoch=2, batch_in_epoch=2, seed=3)
            tp.restore(SamplerState(epoch=1, batch_in_epoch=3, seed=3))
            jp.restore(JSamplerState(epoch=1, batch_in_epoch=3, seed=3))
            for _ in range(4):
                np.testing.assert_array_equal(next(tp).numpy(),
                                              np.asarray(next(jp)))
            with pytest.raises(ValueError, match="seed"):
                tp.restore(SamplerState(epoch=0, batch_in_epoch=0, seed=4))
    finally:
        tctx.close()
        jctx.close()


def test_pipeline_save_and_resume(token_shards, tmp_path):
    ctx = StromContext(StromConfig(queue_depth=4, num_buffers=4))
    kw = dict(batch=4, seq_len=SEQ, seed=5, device="cpu")
    state_path = str(tmp_path / "loader.json")
    try:
        with make_llama_pipeline(ctx, token_shards, **kw) as p:
            for _ in range(3):
                next(p)
            p.save_state(state_path)
            want = [next(p).numpy() for _ in range(4)]
        with make_llama_pipeline(ctx, token_shards, resume_from=state_path,
                                 **kw) as p:
            for w in want:
                np.testing.assert_array_equal(next(p).numpy(), w)
    finally:
        ctx.close()
    assert os.path.exists(state_path)


# ------------------------------------------------------- copied helpers
# The port keeps its own copies of these jax-free helpers; each is held to
# the reference's output on the same inputs.

@pytest.mark.parametrize("cap", [0, 3000, 64 * 1024])
def test_coalesce_matches_reference(cap):
    from strom.delivery import coalesce as jco
    from strom_torch.delivery import coalesce as tco

    rng = np.random.default_rng(cap)
    segs, fo, do = [], 0, 0
    for _ in range(200):      # runs that are adjacent, gapped or overlapping
        ln = int(rng.integers(1, 5000))
        segs.append((fo, do, ln))
        step = ln + int(rng.choice([0, 0, 0, 17, -3]))
        fo, do = fo + max(step, 1), do + max(step, 1)
    perm = rng.permutation(len(segs))
    got = tco.coalesce_segments([Segment(*segs[i]) for i in perm], cap)
    want = jco.coalesce_segments([JSegment(*segs[i]) for i in perm], cap)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    chunks = [(int(i % 3), *segs[i]) for i in perm]
    assert tco.coalesce_chunks(chunks, cap) == jco.coalesce_chunks(chunks, cap)


@pytest.mark.parametrize("index", [
    (), (slice(2, 5),), (slice(None), slice(1, 3)),
    (slice(1, 2), slice(0, 4), slice(2, 6)), (slice(0, 3), slice(None), slice(None)),
])
def test_contiguous_segments_matches_reference(index):
    from strom.delivery.shard import contiguous_segments as jcs
    from strom_torch.delivery.shard import contiguous_segments as tcs

    shape = (6, 4, 8)
    got = [dataclasses.astuple(s) for s in tcs(shape, 4, index)]
    assert got == [dataclasses.astuple(s) for s in jcs(shape, 4, index)]
    # the segments tile the sub-block in row-major order
    arr = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    raw = arr.tobytes()
    out = b"".join(raw[f: f + n] for f, _, n in got)
    assert out == np.ascontiguousarray(arr[index]).tobytes()


def test_extent_locate_matches_reference():
    spans = [("a", 100, 50), ("b", 0, 7), ("a", 4096, 300), ("c", 9, 1)]
    t, j = ExtentList(spans), JExtentList(spans)
    for off, ln, dest in ((0, 358, 0), (120, 60, 11), (157, 1, 0), (357, 1, 5)):
        assert [dataclasses.astuple(r) for r in t.locate(off, ln, dest)] == \
            [dataclasses.astuple(r) for r in j.locate(off, ln, dest)]
    with pytest.raises(ValueError, match="beyond"):
        list(t.locate(300, 100))


@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_order_matches_reference(shuffle):
    from strom.pipelines.sampler import EpochShuffleSampler as JSampler
    from strom_torch.pipelines.sampler import EpochShuffleSampler

    t = iter(EpochShuffleSampler(23, 4, seed=9, shuffle=shuffle))
    j = iter(JSampler(23, 4, seed=9, shuffle=shuffle))
    for _ in range(17):       # three epochs of 5 batches, and two more
        np.testing.assert_array_equal(next(t), next(j))


def test_size_class_and_cpu_slab_pool():
    from strom.delivery.buffers import size_class as j_size_class
    from strom_torch.delivery.buffers import (PAGE, SlabPool, alloc_aligned,
                                              buf_addr, size_class)

    for n in (1, 4096, 4097, 1 << 20, (1 << 20) + 1, 5 * MiB + 3, 1 << 30):
        assert size_class(n) == j_size_class(n), n
    slab = alloc_aligned(10_000)
    assert slab.nbytes == 10_000 and buf_addr(slab) % PAGE == 0
    pool = SlabPool(4 * MiB)
    a = pool.acquire(3 * MiB)
    assert buf_addr(a) % PAGE == 0
    pool.release(a)
    b = pool.acquire(3 * MiB - 5)         # same size class: recycled
    assert buf_addr(b) == buf_addr(a)
    pool.release(b)
    st = pool.stats()
    assert (st["hits"], st["misses"], st["slab_in_use_bytes"],
            st["pinned_bytes"]) == (1, 1, 0, 0)
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.acquire(1)


def test_probe_and_engine_reads(data_file):
    """probe_dio agrees with the reference's; the engine's pool reads
    (submit/wait of ReadRequests), raw reads and read_vectored return the
    file's bytes, and iter_chunks tiles a range."""
    from strom.probe.odirect import probe_dio as j_probe_dio
    from strom_torch.engine import ReadRequest, make_engine
    from strom_torch.engine.base import iter_chunks
    from strom_torch.probe.odirect import probe_dio

    path, data = data_file
    assert dataclasses.astuple(probe_dio(path)) == \
        dataclasses.astuple(j_probe_dio(path))
    assert list(iter_chunks(10, 25, 8)) == [(10, 8), (18, 8), (26, 8), (34, 1)]
    with make_engine(StromConfig(queue_depth=4, num_buffers=4,
                                 block_size=64 * 1024)) as eng:
        fi = eng.register_file(path)
        eng.submit([ReadRequest(fi, 8192 * i, 8192, i, tag=i) for i in range(4)])
        done = []
        while len(done) < 4:
            done += eng.wait(min_completions=4 - len(done))
        assert sorted((c.tag, c.result) for c in done) == \
            [(i, 8192) for i in range(4)]
        for i in range(4):
            np.testing.assert_array_equal(eng.buffer(i)[:8192],
                                          data[8192 * i: 8192 * (i + 1)])
        dest = np.zeros(300_000, dtype=np.uint8)
        n = eng.read_vectored([(fi, 5, 0, 100_000), (fi, MiB, 100_000, 200_000)],
                              dest)
        assert n == 300_000 and eng.in_flight() == 0
        np.testing.assert_array_equal(dest, np.concatenate(
            [data[5: 100_005], data[MiB: MiB + 200_000]]))
