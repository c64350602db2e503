"""The port's NVMe spill tier against the JAX package's.

- ``SpillTier`` alone: one seeded script of ``offer``, ``lookup``,
  ``read_into``, ``unpin``, ``invalidate`` and ``set_partition`` (with an
  entry evicted while pinned), compression off and on, gives equal return
  values, equal entry offsets, equal spill-file bytes, equal
  ``manifest()`` and equal counters in both packages.
- The hot cache over it: pressure evictions demote, cleared and
  invalidated entries do not, equally in both.
- The slice end to end: both contexts at the reference bench's spill arm
  size (a 16 MiB token shard, hot cache 2 MiB with admission "always",
  spill 32 MiB, 32 records a ``pread``) give equal bytes, equal
  ``SPILL_FIELDS`` and ``cache_miss_bytes``, and a second epoch with no
  source misses.
"""

import os

import numpy as np
import pytest

from strom.config import StromConfig as RefConfig
from strom.delivery.core import StromContext as RefContext
from strom.delivery.hotcache import HotCache as RefHotCache
from strom.delivery.spill import SPILL_FIELDS as REF_SPILL_FIELDS
from strom.delivery.spill import SpillTier as RefTier
from strom.formats.rawbin import TokenShardSet as RefShards
from strom.formats.rawbin import write_token_shard as ref_write_tokens
from strom_torch.ckpt.jobstate import capture_warm_state
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.hotcache import HotCache
from strom_torch.delivery.shard import Segment
from strom_torch.delivery.spill import SPILL_FIELDS, SpillTier
from strom_torch.formats.rawbin import TokenShardSet
from strom_torch.formats.rawbin import write_token_shard

KiB = 1024
MiB = 1024 * KiB


def _blob(rng, n: int, compressible: bool) -> np.ndarray:
    if compressible:   # token-like: int32 values below 2^15
        return rng.integers(0, 1 << 15, n // 4,
                            dtype=np.int32).view(np.uint8).copy()
    return rng.integers(0, 256, n, dtype=np.uint8)


def _entries(tier) -> list:
    return sorted((str(k), e.lo, e.hi, e.off, e.cls, e.codec, e.stored,
                   e.tenant) for k, es in tier._index.items() for e in es)


def _read(tier, skey, lo, hi):
    """Serve [lo, hi) of *skey*: (bytes, zero where missing; misses)."""
    out = np.zeros(hi - lo, np.uint8)
    hits, misses = tier.lookup(skey, lo, hi)
    try:
        for s, t, e in hits:
            tier.read_into(e, s, t, out[s - lo: t - lo])
    finally:
        tier.unpin([e for _, _, e in hits])
    return out.tobytes(), misses


def _script(tier, seed: int, compressible: bool) -> list:
    """A seeded sequence of tier calls; returns every call's result."""
    rng = np.random.default_rng(seed)
    log = []
    blobs = {f"k{i}": _blob(rng, int(rng.integers(4, 300)) * KiB,
                            compressible and i % 3 != 2)
             for i in range(10)}
    tier.set_partition("a", 768 * KiB)
    for i, (k, b) in enumerate(blobs.items()):
        tenant = "a" if i % 2 else None
        log.append(("offer", k, tier.offer(k, 0, len(b), b, tenant=tenant)))
    # overlapping and disjoint re-offers: gaps only
    b = blobs["k3"]
    wide = np.concatenate([b, _blob(rng, 64 * KiB, compressible)])
    log.append(("offer_wide", tier.offer("k3", 0, len(wide), wide)))
    log.append(("offer_tail", tier.offer("k4", 4 * KiB, 20 * KiB,
                                         blobs["k4"][4 * KiB: 20 * KiB])))
    for k, b in blobs.items():
        lo = len(b) // 3
        log.append(("read", k, _read(tier, k, lo, len(b) + 8 * KiB)))
    # an entry pinned while eviction pressure and an invalidation hit it
    pin_hits, _ = tier.lookup("k9", 0, len(blobs["k9"]))
    log.append(("pinned", [(s, t, e.off) for s, t, e in pin_hits]))
    for j in range(6):
        big = _blob(rng, 400 * KiB, compressible)
        log.append(("pressure", j, tier.offer(f"p{j}", 0, len(big), big)))
    log.append(("invalidate", tier.invalidate("k9")))
    if pin_hits:
        got = np.zeros(pin_hits[0][1] - pin_hits[0][0], np.uint8)
        tier.read_into(pin_hits[0][2], pin_hits[0][0], pin_hits[0][1], got)
        log.append(("pinned_read", got.tobytes() == blobs["k9"][
            pin_hits[0][0]: pin_hits[0][1]].tobytes()))
    tier.unpin([e for _, _, e in pin_hits])
    # the dead entry's slot recycles on the last unpin
    nb = _blob(rng, 128 * KiB, compressible)
    log.append(("offer_after_unpin", tier.offer("k9", 0, len(nb), nb)))
    log.append(("read_after", _read(tier, "k9", 0, len(nb))))
    tier.set_partition("a", 0)
    log.append(("partitions", tier.partitions()))
    log.append(("entries", tier.entries))
    return log


def _file_bytes(tier) -> bytes:
    with open(tier.path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("compress", [False, True])
def test_scripted_tier_equals_reference(tmp_path, seed, compress):
    ref = RefTier(str(tmp_path / "ref.bin"), 2 * MiB, compress=compress)
    port = SpillTier(str(tmp_path / "port.bin"), 2 * MiB, compress=compress)
    try:
        want = _script(ref, seed, compressible=True)
        got = _script(port, seed, compressible=True)
        assert got == want
        assert _entries(port) == _entries(ref)
        assert _file_bytes(port) == _file_bytes(ref)
        assert port.manifest() == ref.manifest()
        assert port.stats() == ref.stats()
        if compress:
            assert port.stats()["spill_comp_bytes_in"] > \
                port.stats()["spill_comp_bytes_out"] > 0
            assert port.stats()["spill_decomp_bytes"] > 0
        else:
            assert port.stats()["spill_comp_bytes_in"] == 0
    finally:
        ref.close()
        port.close()
    assert not os.path.exists(tmp_path / "port.bin")


def test_spill_fields_equal_reference():
    assert SPILL_FIELDS == REF_SPILL_FIELDS


@pytest.mark.parametrize("compress", [False, True])
def test_hot_cache_demotes_like_reference(tmp_path, compress):
    """Pressure evictions demote to the tier; a cleared or invalidated
    entry does not; a spilled range serves its bytes."""
    out = []
    for mod_cache, mod_tier, name in ((RefHotCache, RefTier, "ref"),
                                      (HotCache, SpillTier, "port")):
        rng = np.random.default_rng(5)
        cache = mod_cache(512 * KiB, admit="always")
        tier = mod_tier(str(tmp_path / f"{name}.bin"), 4 * MiB,
                        compress=compress)
        cache.spill = tier
        blobs = [_blob(rng, 128 * KiB, True) for _ in range(8)]
        for i, b in enumerate(blobs):
            cache.admit(f"f{i}", 0, len(b), b, tenant="t" if i % 2 else None)
        spilled = tier.stats()["spill_spilled_bytes"]
        served = []
        for i, b in enumerate(blobs):
            hits, misses = tier.lookup(f"f{i}", 0, len(b), record=False)
            tier.unpin([e for _, _, e in hits])
            if hits and not misses:   # spilled whole: serves its bytes
                served.append(_read(tier, f"f{i}", 0, len(b))[0]
                              == b.tobytes())
        cache.invalidate("f7")
        cache.clear()
        out.append((spilled, served, tier.manifest(), tier.stats(),
                    cache.stats()["cache_evictions"], _file_bytes(tier)))
        tier.close()
    assert out[1] == out[0]
    assert out[1][0] > 0 and all(out[1][1]) and out[1][1]


def _epoch_pair(ctx, write_tokens, shards_cls, path, toks, step=32,
                record_tokens=1024):
    """The reference bench's spill arm: write the shard through the
    context, read it twice in preads of *step* records; returns both
    epochs' bytes and the context's spill and cache counters after each."""
    write_tokens(ctx, path, toks)
    ss = shards_cls((path,), record_tokens=record_tokens)
    out = []
    for _ in range(2):
        got = [ctx.pread(ss.extents(list(range(lo, lo + step)))).tobytes()
               for lo in range(0, ss.num_records - step + 1, step)]
        st = ctx.stats()
        out.append((got, dict(st["spill"]), dict(st["cache"])))
    return out


@pytest.mark.parametrize("engine_io", [False, True])
@pytest.mark.parametrize("compress", [False, True])
def test_epoch_pair_equals_reference(tmp_path, engine_io, compress):
    fixture = 16 * MiB
    toks = np.random.default_rng(7).integers(0, 1 << 15, fixture // 4,
                                             dtype=np.int32)
    kw = dict(engine="python", hot_cache_bytes=fixture // 8,
              hot_cache_admit="always", spill_bytes=2 * fixture,
              spill_engine_io=engine_io, spill_compress=compress)
    runs = {}
    for name, cfg_cls, ctx_cls, write, shards in (
            ("ref", RefConfig, RefContext, ref_write_tokens, RefShards),
            ("port", StromConfig, StromContext, write_token_shard,
             TokenShardSet)):
        d = tmp_path / name
        d.mkdir()
        ctx = ctx_cls(cfg_cls(spill_dir=str(d), **kw))
        try:
            runs[name] = _epoch_pair(ctx, write, shards, str(d / "tok.bin"),
                                     toks)
        finally:
            ctx.close()
    want_bytes = toks.view(np.uint8).tobytes()
    for name in ("ref", "port"):
        for got, _, _ in runs[name]:
            assert b"".join(got) == want_bytes[: len(b"".join(got))]
            assert len(b"".join(got)) == fixture
    (_, sp1, c1), (_, sp2, c2) = runs["port"]
    (_, rsp1, rc1), (_, rsp2, rc2) = runs["ref"]
    fields = [f for f in SPILL_FIELDS if f in sp2]
    assert {f: sp1[f] for f in fields} == {f: rsp1[f] for f in fields}
    assert {f: sp2[f] for f in fields} == {f: rsp2[f] for f in fields}
    assert c2["cache_miss_bytes"] == rc2["cache_miss_bytes"]
    assert c1["cache_miss_bytes"] == rc1["cache_miss_bytes"] == fixture
    # epoch 2: RAM and spill serve everything, the source is never read
    assert c2["cache_miss_bytes"] - c1["cache_miss_bytes"] == 0
    assert sp2["spill_hit_bytes"] > 0 and sp1["spill_spilled_bytes"] > 0
    assert (sp2["spill_engine_ops"] > 0) == engine_io
    if compress:
        assert sp2["spill_comp_ratio"] == rsp2["spill_comp_ratio"] > 1.0


def test_spill_serves_with_no_source_reads_and_counts_routes(tmp_path):
    """Epoch 2 moves no source byte through the engine: with the engine
    route every engine byte is spill traffic."""
    rng = np.random.default_rng(3)
    ctx = StromContext(StromConfig(
        engine="python", queue_depth=8, num_buffers=16,
        hot_cache_bytes=256 * KiB, hot_cache_admit="always",
        spill_bytes=16 * MiB, spill_dir=str(tmp_path)))
    try:
        p = str(tmp_path / "src.bin")
        data = rng.integers(0, 256, 4 * MiB, dtype=np.uint8)
        data.tofile(p)
        step = 256 * KiB
        for off in range(0, len(data), step):
            ctx.pread(p, offset=off, length=step)
        s1 = ctx.stats()
        eng1 = ctx.engine.stats().get("bytes_read", 0)
        for off in range(0, len(data), step):
            np.testing.assert_array_equal(
                ctx.pread(p, offset=off, length=step), data[off: off + step])
        s2 = ctx.stats()
        served = s2["spill"]["spill_hit_bytes"] - s1["spill"]["spill_hit_bytes"]
        assert served > 0
        assert s2["cache"]["cache_miss_bytes"] == \
            s1["cache"]["cache_miss_bytes"]
        assert ctx.engine.stats().get("bytes_read", 0) - eng1 <= served
        assert s2["spill"]["spill_engine_ops"] > 0
        assert s2["spill"]["spill_errors"] == 0
        assert s2["sched"]["sched_granted_bytes"] > 0
    finally:
        ctx.close()
    assert not any(n.startswith("strom-spill") for n in os.listdir(tmp_path))


@pytest.mark.parametrize("engine_io", [False, True])
def test_warm_promotes_spill_hits_to_ram(tmp_path, engine_io):
    rng = np.random.default_rng(4)
    ctx = StromContext(StromConfig(
        engine="python", hot_cache_bytes=8 * MiB, hot_cache_admit="always",
        spill_bytes=16 * MiB, spill_dir=str(tmp_path),
        spill_engine_io=engine_io))
    try:
        p = str(tmp_path / "src.bin")
        data = rng.integers(0, 256, 512 * KiB, dtype=np.uint8)
        data.tofile(p)
        n = 128 * KiB
        ctx.spill_tier.offer(p, 0, n, data[:n])
        ctx.warm(p, [Segment(0, 0, n)])
        assert ctx.spill_tier.stats()["spill_promote_bytes"] == n
        hit0 = ctx.hot_cache.stats()["cache_hit_bytes"]
        np.testing.assert_array_equal(ctx.pread(p, 0, n), data[:n])
        assert ctx.hot_cache.stats()["cache_hit_bytes"] - hit0 == n
        ctx.warm(p, [Segment(0, 0, n)])   # RAM-resident: no re-promotion
        assert ctx.spill_tier.stats()["spill_promote_bytes"] == n
        assert capture_warm_state(ctx)["spill"] == [[p, 0, n]]
    finally:
        ctx.close()


def test_pwrite_drops_spilled_bytes_of_the_path(tmp_path):
    rng = np.random.default_rng(6)
    ctx = StromContext(StromConfig(
        engine="python", hot_cache_bytes=64 * KiB, hot_cache_admit="always",
        spill_bytes=8 * MiB, spill_dir=str(tmp_path)))
    try:
        p = str(tmp_path / "src.bin")
        old = rng.integers(0, 256, 1 * MiB, dtype=np.uint8)
        ctx.pwrite(p, old)
        for off in range(0, len(old), 64 * KiB):
            ctx.pread(p, off, 64 * KiB)
        assert ctx.spill_tier.entries > 0
        new = rng.integers(0, 256, 1 * MiB, dtype=np.uint8)
        ctx.pwrite(p, new)
        assert ctx.spill_tier.entries == 0
        np.testing.assert_array_equal(ctx.pread(p), new)
    finally:
        ctx.close()


def test_spill_off_keeps_the_plain_cache(tmp_path):
    ctx = StromContext(StromConfig(engine="python", hot_cache_bytes=MiB))
    try:
        assert ctx.spill_tier is None and ctx.hot_cache.spill is None
        assert "spill" not in ctx.stats()
        assert "spill" not in capture_warm_state(ctx)
    finally:
        ctx.close()


def test_full_spill_file_degrades_to_a_drop(tmp_path):
    """An entry larger than the whole spill budget is refused, and the
    eviction that offered it still frees the RAM entry."""
    cache = HotCache(256 * KiB, admit="always")
    tier = SpillTier(str(tmp_path / "s.bin"), 64 * KiB)
    cache.spill = tier
    try:
        rng = np.random.default_rng(8)
        for i in range(4):
            b = rng.integers(0, 256, 128 * KiB, dtype=np.uint8)
            cache.admit(f"k{i}", 0, len(b), b)
        assert tier.entries == 0 and cache.bytes <= 256 * KiB
        tier.close()
        b = rng.integers(0, 256, 128 * KiB, dtype=np.uint8)
        cache.admit("k9", 0, len(b), b)   # a closed tier takes nothing
        assert cache.spill_errors == 0 and tier.entries == 0
    finally:
        tier.close()


@pytest.mark.parametrize("engine", ["python", "uring"])
def test_context_with_spill_closes_on_every_engine(tmp_path, engine):
    """The spill file's engine registrations leave before the engine
    closes (a native ring's handle is gone after), and the file goes."""
    if engine == "uring":
        from strom_torch.engine.uring_engine import uring_available

        if not uring_available():
            pytest.skip("io_uring refused here")
    rng = np.random.default_rng(10)
    p = str(tmp_path / "src.bin")
    data = rng.integers(0, 256, 2 * MiB, dtype=np.uint8)
    data.tofile(p)
    ctx = StromContext(StromConfig(
        engine=engine, hot_cache_bytes=256 * KiB, hot_cache_admit="always",
        spill_bytes=8 * MiB, spill_dir=str(tmp_path)))
    for _ in range(2):
        for off in range(0, data.nbytes, 256 * KiB):
            np.testing.assert_array_equal(ctx.pread(p, off, 256 * KiB),
                                          data[off: off + 256 * KiB])
    assert ctx.stats()["spill"]["spill_engine_ops"] > 0
    ctx.close()
    ctx.close()
    assert not any(n.startswith("strom-spill") for n in os.listdir(tmp_path))
