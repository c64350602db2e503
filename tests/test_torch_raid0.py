"""RAID0 striped sources in the port against the JAX package, on the CPU:
the stripe math, ``stripe_file``'s members and sidecar, and
``memcpy_ssd2gpu`` of a ``StripedFile`` (and of an ExtentList over a striped
alias) against ``memcpy_ssd2tpu``, on the python engine, one ring and four
rings. With four rings every member's ring carries bytes."""

import dataclasses
import os

import numpy as np
import pytest

import strom_torch
from strom.config import StromConfig as JConfig
from strom.delivery.core import StripedFile as JStripedFile
from strom.delivery.core import StromContext as JContext
from strom.delivery.extents import Extent as JExtent
from strom.delivery.extents import ExtentList as JExtentList
from strom.engine import raid0 as jraid
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StripedFile, StromContext, source_size
from strom_torch.delivery.extents import Extent, ExtentList
from strom_torch.engine import raid0 as traid

KiB = 1024
MiB = 1024 * KiB
CHUNK = 64 * KiB


def _flat(segs):
    return [dataclasses.astuple(s) for s in segs]


@pytest.mark.parametrize("n_members,chunk", [
    (1, 4096), (2, 4096), (3, 65536), (4, 512 * KiB), (5, 1000), (8, 131072)])
def test_stripe_math_matches_reference(n_members, chunk):
    rng = np.random.default_rng(n_members * 7919 + chunk)
    cases = [(0, 0), (0, chunk), (chunk - 1, 2), (3 * chunk + 5, 7 * chunk + 11)]
    cases += [(int(o), int(n)) for o, n in zip(rng.integers(0, 50 * chunk, 12),
                                               rng.integers(1, 20 * chunk, 12))]
    for off, ln in cases:
        got = traid.plan_stripe_reads(off, ln, n_members, chunk)
        want = jraid.plan_stripe_reads(off, ln, n_members, chunk)
        assert _flat(got) == _flat(want)
        assert sum(s.length for s in got) == ln
        assert _flat(traid.coalesce(got)) == _flat(jraid.coalesce(want))
        for wb in (-1, 0, chunk, 3 * chunk + 17, 64 * chunk):
            assert _flat(traid.plan_stripe_windows(got, n_members, wb)) == \
                _flat(jraid.plan_stripe_windows(want, n_members, wb))
            assert traid.count_stripe_windows(got, n_members, wb) == \
                jraid.count_stripe_windows(want, n_members, wb)
    sizes = [int(x) for x in rng.integers(0, 40 * chunk, n_members)]
    assert traid.logical_size(sizes, chunk) == jraid.logical_size(sizes, chunk)
    for bad in ((0, 1, 0, chunk), (0, 1, n_members, 0), (-1, 1, n_members, chunk)):
        with pytest.raises(ValueError):
            traid.plan_stripe_reads(*bad)


@pytest.fixture()
def striped(tmp_path):
    """A 3 MiB + 999-byte seeded file striped over 4 members by the port's
    stripe_file: (source path, its bytes, member paths)."""
    data = np.random.default_rng(5).integers(0, 256, 3 * MiB + 999,
                                             dtype=np.uint8)
    src = str(tmp_path / "src.bin")
    data.tofile(src)
    members = [str(tmp_path / f"m{i}.bin") for i in range(4)]
    assert traid.stripe_file(src, members, CHUNK) == data.size
    return src, data, members


def test_stripe_file_matches_reference(striped, tmp_path):
    src, data, members = striped
    os.mkdir(tmp_path / "ref")
    ref = [str(tmp_path / "ref" / f"m{i}.bin") for i in range(4)]
    assert jraid.stripe_file(src, ref, CHUNK) == data.size
    for mine, theirs in zip(members + [members[0] + traid.SIZE_SIDECAR_SUFFIX],
                            ref + [ref[0] + jraid.SIZE_SIDECAR_SUFFIX]):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), mine
    assert traid.SIZE_SIDECAR_SUFFIX == jraid.SIZE_SIDECAR_SUFFIX
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    # the sidecar gives the true size, not the zero-padded stripe width
    sf = StripedFile(tuple(members), CHUNK)
    assert sf.size == source_size(sf) == data.size == \
        JStripedFile(tuple(members), CHUNK).size
    assert StripedFile(tuple(members), CHUNK, size_bytes=5).size == 5


ENGINES = [("python", 1), ("uring", 1), ("uring", 4)]


@pytest.fixture(params=ENGINES, ids=[f"{e}-{r}" for e, r in ENGINES])
def contexts(request):
    engine, rings = request.param
    if engine == "uring":
        from strom_torch.engine import uring_engine

        if not uring_engine.uring_available():
            pytest.skip(f"io_uring unavailable: {uring_engine.unavailable_reason}")
    kw = dict(engine=engine, engine_rings=rings, queue_depth=8, num_buffers=8,
              overlap_chunk_bytes=MiB, overlap_min_bytes=2 * MiB)
    t, j = StromContext(StromConfig(**kw)), JContext(JConfig(**kw))
    assert t.engine.name == j.engine.name
    yield t, j, rings
    t.close()
    j.close()


def _ring_bytes(ctx):
    return [r["bytes_read"] for r in ctx.stats()["engine"]["ring_stats"]]


def test_striped_delivery_matches_reference(contexts, striped):
    tctx, jctx, rings = contexts
    _, data, members = striped
    sf, jsf = StripedFile(tuple(members), CHUNK), JStripedFile(tuple(members), CHUNK)
    streamed0 = tctx.stats()["context"]["streamed_transfers"]
    # the whole logical file, streamed (3 MiB > the 2 MiB threshold)
    got = tctx.memcpy_ssd2gpu(sf, device="cpu").numpy()
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, np.asarray(jctx.memcpy_ssd2tpu(jsf)))
    assert tctx.stats()["context"]["streamed_transfers"] - streamed0 == 1
    if rings > 1:
        assert tctx.engine.concurrent_gathers
        assert all(b > 0 for b in _ring_bytes(tctx)), _ring_bytes(tctx)
    # a range that starts and ends inside stripe chunks, as a typed array
    kw = dict(offset=CHUNK + 4096, shape=(100, 1000), dtype=np.int32)
    got = tctx.memcpy_ssd2gpu(sf, device="cpu", **kw).numpy()
    want = data[CHUNK + 4096:][: 400_000].view(np.int32).reshape(100, 1000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jctx.memcpy_ssd2tpu(jsf, **kw)))


def test_extent_list_over_striped_alias_matches_reference(contexts, striped,
                                                          tmp_path):
    tctx, jctx, rings = contexts
    src, data, members = striped
    alias = str(tmp_path / "alias.bin")      # no such file: only an alias
    for ctx in (tctx, jctx):
        ctx.register_striped(alias, members, CHUNK)
    assert tctx.striped_source(alias) == StripedFile(tuple(members), CHUNK)
    assert tctx.resolve_source(alias).size == data.size
    assert tctx.resolve_source(src) == src
    # adjacent runs over the alias (merged before striping), a plain file
    # in between, and a run across the unaligned tail
    spans = [(alias, 100, 70_000), (alias, 70_100, 200_000), (src, 5, 9_000),
             (alias, 2 * MiB + 3, 900_000), (alias, data.size - 5000, 5000)]
    got = tctx.memcpy_ssd2gpu(ExtentList([Extent(*s) for s in spans]),
                              device="cpu").numpy()
    want = np.concatenate([data[o: o + n] for _, o, n in spans])
    np.testing.assert_array_equal(got, want)
    jgot = jctx.memcpy_ssd2tpu(JExtentList([JExtent(*s) for s in spans]))
    np.testing.assert_array_equal(got, np.asarray(jgot))
    if rings > 1:
        assert all(b > 0 for b in _ring_bytes(tctx)), _ring_bytes(tctx)
    # the alias read whole by its path
    np.testing.assert_array_equal(tctx.memcpy_ssd2gpu(alias, device="cpu").numpy(),
                                  data)


def test_llama_pipeline_over_striped_alias_matches_reference(contexts,
                                                            striped):
    """A loader over a striped alias (a path that is not on disk): the
    shard's size and the loader's fingerprint come through the context, as
    the reference's do, and the batches equal the reference's."""
    import jax
    from jax.sharding import SingleDeviceSharding

    from strom.pipelines import make_llama_pipeline as j_make_llama_pipeline
    from strom_torch.pipelines import make_llama_pipeline

    tctx, jctx, _ = contexts
    _, _, members = striped
    alias = str(os.path.dirname(members[0])) + "/tokens.raid0"
    for ctx in (tctx, jctx):
        ctx.register_striped(alias, members, CHUNK)
    kw = dict(batch=4, seq_len=255, seed=3)
    with make_llama_pipeline(tctx, [alias], device="cpu", **kw) as tp, \
            j_make_llama_pipeline(
                jctx, [alias], sharding=SingleDeviceSharding(jax.devices()[0]),
                **kw) as jp:
        assert tp.fingerprint == jp.fingerprint
        assert tp.sampler.num_records == (3 * MiB + 999) // 1024
        for _ in range(3):
            np.testing.assert_array_equal(next(tp).numpy(), np.asarray(next(jp)))


def test_plan_windows_members_and_skips_op_coalescing(striped):
    """Striped plans match the reference's op for op: member ops come in
    per-member runs inside windows of the in-flight budget, and are not
    merged at the op level."""
    from strom.delivery.shard import Segment as JSegment
    from strom_torch.delivery.shard import Segment

    _, data, members = striped
    kw = dict(engine="python", queue_depth=8, block_size=64 * KiB)
    t, j = StromContext(StromConfig(**kw)), JContext(JConfig(**kw))
    try:
        sf, jsf = StripedFile(tuple(members), CHUNK), JStripedFile(tuple(members), CHUNK)
        plans = []
        for segs in ([(0, 0, data.size)], [(5, 0, 300_000), (300_005, 300_000, 7)]):
            plans.append(t._plan_chunks(sf, [Segment(*s) for s in segs]))
            want, _ = j._plan_chunks(jsf, [JSegment(*s) for s in segs])
            assert plans[-1] == want
        # a 512 KiB window holds two chunks of each member, run by member
        assert t.config.resolved_stripe_window_bytes == 8 * CHUNK
        assert [fi for fi, *_ in plans[0][:8]] == [0, 0, 1, 1, 2, 2, 3, 3]
        assert len(plans[0]) == -(-data.size // CHUNK)
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("window", [0, 3 * CHUNK + 17, 2 * MiB])
def test_stripe_window_setting_matches_reference(striped, window):
    """stripe_window_bytes away from its default: 0 keeps the logical
    chunk order, a positive width sets the window. The plans equal the
    reference's op for op, and the delivered bytes the file's."""
    from strom.delivery.shard import Segment as JSegment
    from strom_torch.delivery.shard import Segment

    _, data, members = striped
    kw = dict(engine="python", queue_depth=8, block_size=64 * KiB,
              stripe_window_bytes=window)
    t, j = StromContext(StromConfig(**kw)), JContext(JConfig(**kw))
    try:
        assert t.config.resolved_stripe_window_bytes == window == \
            j.config.resolved_stripe_window_bytes
        sf, jsf = StripedFile(tuple(members), CHUNK), JStripedFile(tuple(members), CHUNK)
        segs = [(7, 0, 2 * MiB), (2 * MiB + 11, 2 * MiB, 500_000)]
        plan = t._plan_chunks(sf, [Segment(*s) for s in segs])
        want, _ = j._plan_chunks(jsf, [JSegment(*s) for s in segs])
        assert plan == want
        if window == 0:   # chunk-granular logical order: members in turn
            assert [fi for fi, *_ in plan[:8]] == [0, 1, 2, 3, 0, 1, 2, 3]
        got = t.memcpy_ssd2gpu(sf, device="cpu").numpy()
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(got, np.asarray(j.memcpy_ssd2tpu(jsf)))
    finally:
        t.close()
        j.close()


def test_module_level_register_striped(striped, tmp_path):
    _, data, members = striped
    strom_torch.init(StromConfig(engine="python", queue_depth=4, num_buffers=4))
    try:
        alias = str(tmp_path / "virt.bin")
        sf = strom_torch.register_striped(alias, members, CHUNK)
        assert isinstance(sf, strom_torch.StripedFile) and sf.size == data.size
        got = strom_torch.memcpy_ssd2gpu(alias, length=MiB, device="cpu")
        np.testing.assert_array_equal(got.numpy(), data[:MiB])
        with pytest.raises(ValueError, match="chunk is required"):
            strom_torch.register_striped(alias, members)
        with pytest.raises(ValueError, match="conflicts"):
            strom_torch.register_striped(alias, sf, chunk=CHUNK * 2)
        assert strom_torch.register_striped(alias, sf, size=10).size == 10
    finally:
        strom_torch.close()
