"""The port's resilience layer end to end, held to the JAX package's on the
same seeded file and plans: streamed and demand gathers under injected EIO
and short reads land the clean bytes; engine death mid-gather recovers
each chunk on the fallback engine; a demand gather that trips the breaker
fails over under the tenant's scheduler grants; a streamed gather feeds
the breaker once."""

import json

import numpy as np
import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.buffers import alloc_aligned as j_alloc
from strom.delivery.core import StromContext as JContext
from strom.delivery.shard import Segment as JSegment
from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.shard import Segment
from strom_torch.engine.base import EngineError
from strom_torch.engine.resilience import RESILIENCE_FIELDS
from strom_torch.utils.stats import global_stats

MiB = 1 << 20

CFG = dict(engine="python", queue_depth=8, num_buffers=16,
           io_retry_backoff_s=0.001, io_retry_backoff_max_s=0.004,
           hot_cache_bytes=0, residency_hybrid=False)

PLANS = {
    "eio": {"seed": 11, "rules": [{"kind": "errno", "every": 5,
                                   "times": 3}]},
    "short": {"seed": 11, "rules": [{"kind": "short_read", "every": 7,
                                     "times": 3, "short_frac": 0.5}]},
    "mixed": {"seed": 11, "rules": [
        {"kind": "errno", "every": 5, "times": 3},
        {"kind": "short_read", "every": 7, "times": 3, "short_frac": 0.5},
        {"kind": "latency", "every": 11, "times": 2, "latency_s": 0.005}]},
    "chaos": "chaos:0",
}


def _spec(plan) -> str:
    return plan if isinstance(plan, str) else json.dumps(plan)


def _counters() -> dict:
    return {k: global_stats.counter(k).value for k in RESILIENCE_FIELDS
            if k != "breaker_state"}


def _delta(before: dict) -> dict:
    now = _counters()
    return {k: now[k] - before[k] for k in now}


def _stream(ctx, path, nbytes, alloc=alloc_aligned, seg=Segment):
    dest = alloc(nbytes)
    g = ctx.stream_segments(path, [seg(0, 0, nbytes)], dest)
    try:
        while not g.done:
            g.poll(min_completions=1, timeout_s=0.5)
        g.finish()
    finally:
        g.close()
    return dest


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("route", ["stream", "demand"])
def test_faulted_gather_lands_clean_bytes(name, route, data_file):
    path, golden = data_file
    n = 2 * MiB
    spec = _spec(PLANS[name])
    outs = []
    for Ctx, Cfg, alloc, seg in ((JContext, JConfig, j_alloc, JSegment),
                                 (StromContext, StromConfig, alloc_aligned,
                                  Segment)):
        ctx = Ctx(Cfg(fault_plan=spec, io_retries=3, **CFG))
        try:
            before = _counters()
            if route == "stream":
                out = _stream(ctx, path, n, alloc, seg)
            else:
                out = ctx.pread(path, 0, n)
            injected = ctx.engine.plan.stats()["faults_injected"]
            outs.append((np.asarray(out[:n]).copy(), injected))
        finally:
            ctx.close()
    (jout, jinj), (tout, tinj) = outs
    np.testing.assert_array_equal(tout, golden[:n])
    np.testing.assert_array_equal(tout, jout)
    assert tinj > 0
    if route == "demand" or name != "chaos":
        # the demand gather's op stream is the same in both packages
        assert tinj == jinj
    d = _delta(before)
    if name in ("eio", "short"):
        # every injected fault cost exactly one retry
        assert d["chunk_retries"] == tinj
    if name != "chaos":
        assert d["faults_injected"] == tinj


def test_stats_carry_every_resilience_field(data_file):
    path, _ = data_file
    with StromContext(StromConfig(fault_plan=_spec(PLANS["eio"]),
                                  io_retries=3, **CFG)) as ctx:
        ctx.pread(path, 0, 4 * MiB)
        st = ctx.stats()
        assert set(RESILIENCE_FIELDS) <= set(st["resilience"])
        assert st["resilience"]["state"] == "closed"
        assert st["resilience"]["fault_plan"]["by_kind"]["errno"] == 3
        assert st["engine"]["engine"] == "faulty+python"


def test_engine_death_recovers_each_chunk_on_fallback(data_file):
    """The engine dies mid-gather: the streamed gather reads every chunk
    it had not landed on the fallback engine, in both packages."""
    path, golden = data_file
    plan = json.dumps({"seed": 0, "rules": [{"kind": "engine_death",
                                             "op_lo": 4}]})
    kw = dict(fault_plan=plan, io_retries=1, io_retry_budget=4,
              breaker_min_events=2, **CFG)
    jctx = JContext(JConfig(**kw, hedge_enabled=False))
    try:
        jout = _stream(jctx, path, 2 * MiB, j_alloc, JSegment)
        jfo = jctx.stats(sections=("resilience",))["resilience"]
    finally:
        jctx.close()
    with StromContext(StromConfig(**kw)) as ctx:
        before = _counters()
        out = _stream(ctx, path, 2 * MiB)
        d = _delta(before)
        st = ctx.stats()
    np.testing.assert_array_equal(out, golden[:2 * MiB])
    np.testing.assert_array_equal(out, jout)
    assert d["failover_reads"] > 0 and d["failover_bytes"] > 0
    assert st["resilience"]["fault_plan"]["engine_dead"] is True
    assert jfo["fault_plan"]["engine_dead"] is True
    assert st["resilience"]["failover_available"] is True


@pytest.mark.parametrize("sched_enabled", [True, False])
def test_demand_failover_keeps_the_grants(sched_enabled, data_file):
    """The gather that trips the breaker is read by the fallback; under the
    scheduler every fallback slice is granted to the caller's tenant, so
    its granted bytes cover the failover and no grant is left held. While
    the breaker is open the primary sees no op."""
    path, golden = data_file
    plan = json.dumps({"seed": 0, "rules": [{"kind": "engine_death"}]})
    cfg = StromConfig(fault_plan=plan, io_retries=1, io_retry_budget=2,
                      breaker_min_events=2, breaker_error_rate=0.5,
                      breaker_cooldown_s=60.0, sched_slice_bytes=64 * 1024,
                      sched_enabled=sched_enabled, **CFG)
    with StromContext(cfg) as ctx:
        ctx.register_tenant("t0") if sched_enabled else None
        with pytest.raises(EngineError):
            ctx.pread(path, 0, 256 * 1024, tenant="t0")
        before = _counters()
        g0 = ctx.scheduler.tenant("t0").granted_bytes if sched_enabled \
            else 0
        out = ctx.pread(path, 0, 256 * 1024, tenant="t0")
        np.testing.assert_array_equal(out, golden[:256 * 1024])
        d = _delta(before)
        assert d["breaker_trips"] == 1
        assert d["failover_reads"] >= 1 and d["failover_bytes"] == 256 * 1024
        assert ctx.stats()["resilience"]["state"] == "open"
        if sched_enabled:
            t = ctx.scheduler.tenant("t0")
            # the primary's failing slices plus four 64 KiB failover slices
            assert t.granted_bytes - g0 >= 256 * 1024
            assert ctx.scheduler.stats()["sched_active_grants"] == 0
        ops = ctx.engine.plan.stats()["ops_seen"]
        out = ctx.pread(path, MiB, 128 * 1024, tenant="t0")
        np.testing.assert_array_equal(out, golden[MiB:MiB + 128 * 1024])
        assert ctx.engine.plan.stats()["ops_seen"] == ops


def test_failover_under_a_held_grant_takes_no_second_grant(data_file):
    """A thread that holds a grant (a spill demotion's) and fails over
    reads the fallback without queueing for another grant: no deadlock."""
    path, golden = data_file
    plan = json.dumps({"seed": 0, "rules": [{"kind": "engine_death"}]})
    cfg = StromConfig(fault_plan=plan, io_retries=0, breaker_min_events=1,
                      breaker_cooldown_s=60.0, **CFG)
    with StromContext(cfg) as ctx:
        ctx.resilience.breaker.record_failure()   # open
        sched = ctx.scheduler
        calls = []

        def arbitrate_probe(read_slice):
            calls.append(sched.held_by_me())
            return read_slice([(ctx.file_index(path), 0, 0, 64 * 1024)])

        dest = alloc_aligned(64 * 1024)
        with sched.grant(None, 0):
            n = ctx.resilience.execute(
                lambda: 0, [(ctx.file_index(path), 0, 0, 64 * 1024)], dest,
                {ctx.file_index(path): path}, arbitrate=arbitrate_probe)
            # the context's own arbitrate path, on this grant-holding thread
            out = ctx.pread(path, 0, 64 * 1024)
        assert n == 64 * 1024 and calls == [True]
        np.testing.assert_array_equal(dest, golden[:64 * 1024])
        np.testing.assert_array_equal(out, golden[:64 * 1024])


def test_streamed_gather_feeds_breaker_once(data_file):
    path, golden = data_file
    plan = json.dumps({"seed": 0, "rules": [{"kind": "errno", "every": 2,
                                             "times": 3}]})
    infos = []
    for Ctx, Cfg, alloc, seg in ((JContext, JConfig, j_alloc, JSegment),
                                 (StromContext, StromConfig, alloc_aligned,
                                  Segment)):
        ctx = Ctx(Cfg(fault_plan=plan, io_retries=0,
                      breaker_min_events=100, **CFG))
        try:
            dest = _stream(ctx, path, 2 * MiB, alloc, seg)
            np.testing.assert_array_equal(np.asarray(dest),
                                          golden[:2 * MiB])
            a = ctx.resilience.breaker.info()
            dest = _stream(ctx, path, MiB, alloc, seg)   # plan spent: clean
            np.testing.assert_array_equal(np.asarray(dest), golden[:MiB])
            infos.append((a, ctx.resilience.breaker.info()))
        finally:
            ctx.close()
    (ja, jb), (ta, tb) = infos
    assert (ta["window_events"], ta["window_failures"]) == (1, 1)
    assert (tb["window_events"], tb["window_failures"]) == (2, 1)
    assert (ta, tb) == (ja, jb)


def test_breaker_off_propagates_and_writes_feed_it(data_file, tmp_path):
    path, _ = data_file
    plan = json.dumps({"seed": 0, "rules": [{"kind": "engine_death"}]})
    with StromContext(StromConfig(fault_plan=plan, io_retries=0,
                                  breaker_enabled=False, **CFG)) as ctx:
        assert ctx.resilience.breaker is None
        for _ in range(3):
            with pytest.raises(EngineError):
                ctx.pread(path, 0, 64 * 1024)
    wplan = json.dumps({"seed": 0, "rules": [{"kind": "errno",
                                              "op": "write"}]})
    with StromContext(StromConfig(fault_plan=wplan, io_retries=0,
                                  breaker_min_events=1, **CFG)) as ctx:
        with pytest.raises(EngineError):
            ctx.pwrite(str(tmp_path / "w.bin"), np.ones(4096, np.uint8))
        assert ctx.resilience.breaker.info()["window_failures"] == 1
        assert ctx.stats()["resilience"]["state"] == "open"
