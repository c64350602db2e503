"""Hedged reads of the port's streamed gather, held to the JAX package's on
the same seeded file and fault plans (exact bytes and equal counters): a
read op held by a ``latency`` rule past the hedge threshold is re-read on
the fallback engine and the first completion wins; a chunk whose fallback
read fails too is hedged once only; a primary completing after the hedge
counts its bytes in ``hedge_wasted_bytes``; ``hedge_enabled=False`` and the
zero threshold fire none."""

import json
import time

import numpy as np
import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.buffers import alloc_aligned as j_alloc
from strom.delivery.core import StromContext as JContext
from strom.delivery.shard import Segment as JSegment
from strom.utils.stats import global_stats as j_stats
from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.shard import Segment
from strom_torch.utils.stats import global_stats

MiB = 1 << 20
HEDGE_KEYS = ("hedges_fired", "hedges_won", "hedge_wasted_bytes",
              "failover_reads")

CFG = dict(engine="python", queue_depth=8, num_buffers=16,
           hot_cache_bytes=0, residency_hybrid=False,
           io_retry_backoff_s=0.001, io_retry_backoff_max_s=0.004)

# both packages: (context, config, allocator, segment, registry)
PKGS = {"jax": (JContext, JConfig, j_alloc, JSegment, j_stats),
        "torch": (StromContext, StromConfig, alloc_aligned, Segment,
                  global_stats)}


def _counts(reg) -> dict:
    return {k: reg.counter(k).value for k in HEDGE_KEYS}


def _stream(pkg: str, path: str, nbytes: int, **cfg):
    """One streamed gather of [0, nbytes) under *cfg*: (dest, counter
    deltas, wall seconds, the context's hedge threshold in us or None)."""
    Ctx, Cfg, alloc, seg, reg = PKGS[pkg]
    ctx = Ctx(Cfg(**{**CFG, **cfg}))
    try:
        before = _counts(reg)
        t0 = time.monotonic()
        dest = alloc(nbytes)
        g = ctx.stream_segments(path, [seg(0, 0, nbytes)], dest)
        try:
            while not g.done:
                g.poll(min_completions=1, timeout_s=0.5)
            g.finish()
        finally:
            g.close()
        wall = time.monotonic() - t0
        after = _counts(reg)
        hedge = ctx.resilience.hedge
        thr = None if hedge is None else round(hedge.threshold_s() * 1e6, 1)
        assert ctx.engine.in_flight() == 0, "the loser was reaped"
        return dest, {k: after[k] - before[k] for k in HEDGE_KEYS}, wall, thr
    finally:
        ctx.close()


def _hold(latency_s: float, op: int = 0) -> str:
    """A plan holding read op *op* (and only it) for *latency_s*."""
    return json.dumps({"seed": 0, "rules": [
        {"kind": "latency", "op": "read", "op_lo": op, "op_hi": op + 1,
         "latency_s": latency_s}]})


def test_held_op_is_hedged_and_the_hedge_wins(data_file):
    path, golden = data_file
    got = {}
    for pkg in PKGS:
        dest, d, wall, thr = _stream(pkg, path, MiB, fault_plan=_hold(0.5),
                                     hedge_min_s=0.05, hedge_multiplier=0.0)
        np.testing.assert_array_equal(dest, golden[:MiB])
        assert wall < 5.0
        got[pkg] = (d, thr)
    assert got["torch"] == got["jax"]
    d, thr = got["torch"]
    assert d["hedges_fired"] == 1 and d["hedges_won"] == 1
    assert thr == 50000.0


def test_hedges_off_fire_none(data_file):
    path, golden = data_file
    got = {}
    for pkg in PKGS:
        dest, d, _, thr = _stream(pkg, path, MiB, fault_plan=_hold(0.2),
                                  hedge_enabled=False)
        np.testing.assert_array_equal(dest, golden[:MiB])
        got[pkg] = (d, thr)
    assert got["torch"] == got["jax"]
    assert got["torch"] == ({k: 0 for k in HEDGE_KEYS}, None)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_zero_threshold_is_off(pkg):
    Ctx, Cfg, *_ = PKGS[pkg]
    ctx = Ctx(Cfg(**CFG, hedge_min_s=0.0, hedge_multiplier=0.0))
    try:
        assert ctx.resilience.hedge is None
    finally:
        ctx.close()


def test_chunk_whose_fallback_fails_is_hedged_once(data_file):
    """Every op stuck and a fallback that never serves: each chunk with a
    piece in flight is hedged exactly once, however often the gather is
    polled."""
    path, _ = data_file
    plan = json.dumps({"seed": 0, "rules": [{"kind": "stuck"}]})
    fired = {}
    for pkg in PKGS:
        Ctx, Cfg, alloc, seg, reg = PKGS[pkg]
        ctx = Ctx(Cfg(**CFG, fault_plan=plan, hedge_min_s=0.02,
                      hedge_multiplier=0.0, breaker_enabled=False))
        try:
            before = reg.counter("hedges_fired").value
            dest = alloc(128 * 1024)
            g = ctx.stream_segments(path, [seg(0, 0, 128 * 1024)], dest)
            try:
                ctx.resilience.read_chunk_fallback = lambda *a, **k: False
                nchunks = len(g._chunks)
                end = time.monotonic() + 1.0
                while time.monotonic() < end:
                    g.poll(min_completions=1, timeout_s=0.05)
            finally:
                g.close()
            fired[pkg] = (reg.counter("hedges_fired").value - before,
                          nchunks)
        finally:
            ctx.close()
    assert fired["torch"] == fired["jax"]
    assert fired["torch"][0] == fired["torch"][1]


def test_loser_bytes_count_as_wasted(data_file):
    """Queue depth 1 and two chunks: the held primary piece of chunk 0
    loses to its hedge while chunk 1 waits behind it. The loser's late
    completion is dropped (no range emitted twice) and its bytes count in
    hedge_wasted_bytes; chunk 1 then lands from the primary.

    Once the hedge has won, the test lifts the threshold out of reach. The
    loser's completion marks no progress, so without that the quiet clock
    can run out while chunk 1's read (submitted when the loser retires) is
    in flight, and chunk 1 would be hedged too: both packages race the
    same way under load."""
    path, golden = data_file
    blk = 128 * 1024
    want = np.concatenate([golden[:blk], golden[MiB: MiB + blk]])
    got = {}
    for pkg in PKGS:
        Ctx, Cfg, alloc, seg, reg = PKGS[pkg]
        ctx = Ctx(Cfg(**{**CFG, "queue_depth": 1}, fault_plan=_hold(0.2),
                      hedge_min_s=0.03, hedge_multiplier=0.0))
        try:
            before = _counts(reg)
            dest = alloc(2 * blk)
            g = ctx.stream_segments(path, [seg(0, 0, blk),
                                           seg(MiB, blk, blk)], dest)
            ranges = []
            try:
                end = time.monotonic() + 10.0
                while not g.done and time.monotonic() < end:
                    ranges.extend(g.poll(min_completions=1, timeout_s=0.5))
                    if reg.counter("hedges_won").value \
                            > before["hedges_won"]:
                        # the race is decided: no second hedge pass
                        ctx.resilience.hedge.min_s = 3600.0
                g.finish()
            finally:
                g.close()
            after = _counts(reg)
            assert len(ranges) == len(set(ranges)) == 2
            np.testing.assert_array_equal(dest, want)
            got[pkg] = {k: after[k] - before[k] for k in HEDGE_KEYS}
        finally:
            ctx.close()
    assert got["torch"] == got["jax"]
    assert got["torch"]["hedges_won"] == 1
    assert got["torch"]["hedge_wasted_bytes"] == blk
