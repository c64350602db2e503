"""Request deadlines in the port, beside the JAX package's: a gather under
a latency rule fails fast with DeadlineExceeded and counts it, the
config's default deadline applies, the scheduler dequeues a waiter whose
deadline passed, the async token's poll honours its deadline, and a
wedged engine without a deadline raises the diagnosable stall error."""

import errno
import json
import threading
import time

import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.engine.base import DeadlineExceeded as JDeadline
from strom.engine.python_engine import PythonEngine as JPythonEngine
from strom.faults import FaultPlan as JPlan
from strom.faults import FaultRule as JRule
from strom.faults import FaultyEngine as JFaulty
from strom.obs import request as jreq
from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.shard import Segment
from strom_torch.engine.base import (DeadlineExceeded, EngineError,
                                     EngineStallError)
from strom_torch.engine.python_engine import PythonEngine
from strom_torch.faults import FaultPlan, FaultRule, FaultyEngine
from strom_torch.obs import request as treq
from strom_torch.utils.stats import global_stats

# the reference's drain grace after a deadline miss (engine/base.py)
DRAIN_GRACE_S = 1.0
LATENCY = json.dumps({"seed": 0, "rules": [{"kind": "latency",
                                            "latency_s": 0.5}]})
STUCK = json.dumps({"seed": 0, "rules": [{"kind": "stuck"}]})
BOTH = [(JContext, JConfig, JDeadline), (StromContext, StromConfig,
                                          DeadlineExceeded)]
IDS = ["jax_package", "port"]


def _cfg(Cfg, **kw):
    kw.setdefault("engine", "python")
    return Cfg(queue_depth=8, num_buffers=16, hot_cache_bytes=0,
               breaker_enabled=False, residency_hybrid=False, **kw)


@pytest.mark.parametrize("Ctx,Cfg,Exc", BOTH, ids=IDS)
@pytest.mark.parametrize("sched_enabled", [True, False])
def test_latency_gather_fails_fast(Ctx, Cfg, Exc, sched_enabled, data_file):
    path, _ = data_file
    ctx = Ctx(_cfg(Cfg, fault_plan=LATENCY, sched_enabled=sched_enabled))
    try:
        before = global_stats.counter("deadline_exceeded").value
        t0 = time.monotonic()
        with pytest.raises(Exc) as ei:
            ctx.pread(path, 0, 256 * 1024, deadline_s=0.05)
        took = time.monotonic() - t0
        assert ei.value.errno == errno.ETIMEDOUT
        assert took < 0.05 + DRAIN_GRACE_S, took
        if Ctx is StromContext:
            assert global_stats.counter("deadline_exceeded").value > before
            assert ctx.stats()["resilience"]["deadline_exceeded"] > before
    finally:
        ctx.close()


@pytest.mark.parametrize("Ctx,Cfg,Exc", BOTH, ids=IDS)
@pytest.mark.parametrize("plan", [LATENCY, STUCK], ids=["latency", "stuck"])
def test_config_default_deadline_applies(Ctx, Cfg, Exc, plan, data_file):
    path, golden = data_file
    ctx = Ctx(_cfg(Cfg, fault_plan=plan, request_deadline_s=0.1))
    try:
        t0 = time.monotonic()
        with pytest.raises(Exc):
            ctx.pread(path, 0, 128 * 1024)
        # a stuck op never completes: its drain waits the whole grace
        slack = 0.5 if plan is STUCK else 0.0
        assert time.monotonic() - t0 < 0.1 + DRAIN_GRACE_S + slack
    finally:
        ctx.close()
    with StromContext(_cfg(StromConfig, request_deadline_s=5.0)) as ok:
        assert (ok.pread(path, 0, 4096) == golden[:4096]).all()


@pytest.mark.parametrize("mod,Exc", [(jreq, JDeadline),
                                     (treq, DeadlineExceeded)], ids=IDS)
def test_scheduler_dequeues_an_expired_waiter(mod, Exc):
    """A tenant queued behind a held grant leaves the queue at its
    deadline with the typed error, and the queue is empty after."""
    if mod is jreq:
        from strom.sched.scheduler import IoScheduler
        eng, cfg = JPythonEngine(JConfig(engine="python")), \
            JConfig(engine="python")
    else:
        from strom_torch.sched.scheduler import IoScheduler
        eng, cfg = PythonEngine(StromConfig(engine="python")), \
            StromConfig(engine="python")
    sched = IoScheduler(eng, cfg)
    try:
        holder = sched.acquire("a", 1 << 20)
        got = {}

        def waiter():
            with mod.active("gather", "b") as req:
                req.set_deadline_s(0.15)
                t0 = time.monotonic()
                try:
                    sched.acquire("b", 4096)
                except Exception as e:   # noqa: BLE001 - recorded below
                    got["exc"] = e
                got["s"] = time.monotonic() - t0

        th = threading.Thread(target=waiter)
        th.start()
        th.join(5.0)
        assert isinstance(got["exc"], Exc)
        assert 0.1 <= got["s"] < 1.0
        assert len(sched.tenant("b").queue) == 0
        sched.release(holder)
        assert sched.stats()["sched_active_grants"] == 0
    finally:
        eng.close()


def test_sliced_gather_stops_between_slices(data_file):
    """read_chunks checks the deadline before every slice: a request whose
    deadline has passed moves no slice at all."""
    path, _ = data_file
    with StromContext(_cfg(StromConfig, sched_slice_bytes=64 * 1024)) as ctx:
        fi = ctx.file_index(path)
        dest = alloc_aligned(256 * 1024)
        with treq.active("gather") as req:
            req.deadline = time.monotonic() - 1.0
            with pytest.raises(DeadlineExceeded):
                ctx.scheduler.read_chunks([(fi, 0, 0, 256 * 1024)], dest)


@pytest.mark.parametrize("pkg", IDS)
def test_poll_path_honours_the_deadline(pkg, data_file):
    path, _ = data_file
    if pkg == "port":
        eng = FaultyEngine(PythonEngine(StromConfig(
            engine="python", queue_depth=8, num_buffers=8)),
            FaultPlan([FaultRule("stuck")], seed=0))
        Exc = DeadlineExceeded
    else:
        eng = JFaulty(JPythonEngine(JConfig(
            engine="python", queue_depth=8, num_buffers=8)),
            JPlan([JRule("stuck")], seed=0))
        Exc = JDeadline
    try:
        fi = eng.register_file(path)
        dest = alloc_aligned(256 * 1024)
        tok = eng.submit_vectored([(fi, 0, 0, 256 * 1024)], dest,
                                  retries=0, deadline=time.monotonic() + 0.2)
        t0 = time.monotonic()
        with pytest.raises(Exc):
            eng.drain(tok)
        assert time.monotonic() - t0 < 2.0
        # every chunk closed with the deadline's errno
        assert all(r == -errno.ETIMEDOUT for r in tok._results)
        eng.cancel(tok, timeout_s=2.0)
        assert eng.in_flight() == 0
    finally:
        eng.close()


def test_streamed_gather_deadline(data_file):
    """A streamed gather minted under request_deadline_s over a stuck
    engine raises DeadlineExceeded from finish, its token cancelled."""
    path, _ = data_file
    # hedges off: a hedge would serve the stuck chunk on the fallback
    # engine before the deadline
    with StromContext(_cfg(StromConfig, fault_plan=STUCK,
                           request_deadline_s=0.2,
                           hedge_enabled=False)) as ctx:
        dest = alloc_aligned(256 * 1024)
        g = ctx.stream_segments(path, [Segment(0, 0, 256 * 1024)], dest)
        t0 = time.monotonic()
        try:
            with pytest.raises(DeadlineExceeded):
                while not g.done and time.monotonic() - t0 < 5.0:
                    g.poll(min_completions=1, timeout_s=0.05)
                g.finish()
        finally:
            g.close()
        assert time.monotonic() - t0 < 0.2 + DRAIN_GRACE_S + 1.0
        assert ctx.engine.in_flight() == 0


def test_no_deadline_stall_raises_diagnosable_error(data_file):
    path, _ = data_file
    cfg = StromConfig(engine="python", queue_depth=8, num_buffers=8,
                      engine_wait_timeout_s=0.3)
    eng = FaultyEngine(PythonEngine(cfg), FaultPlan([FaultRule("stuck")],
                                                    seed=0))
    try:
        fi = eng.register_file(path)
        before = global_stats.counter("engine_stall_timeouts").value
        with pytest.raises(EngineStallError) as ei:
            eng.read_vectored([(fi, 0, 0, 64 * 1024)],
                              alloc_aligned(64 * 1024), retries=0)
        assert ei.value.stuck_tags and ei.value.errno == errno.ETIMEDOUT
        assert global_stats.counter("engine_stall_timeouts").value > before
    finally:
        eng.close()


def test_backoff_retry_denied_by_deadline(data_file):
    """A failed piece whose retry the policy would take, past the
    deadline, fails with DeadlineExceeded rather than EIO."""
    path, _ = data_file
    plan = json.dumps({"seed": 0, "rules": [
        {"kind": "latency", "latency_s": 0.15, "times": 1},
        {"kind": "errno"}]})
    with StromContext(_cfg(StromConfig, fault_plan=plan, io_retries=5,
                           io_retry_backoff_s=0.2,
                           io_retry_backoff_max_s=0.2)) as ctx:
        with pytest.raises(DeadlineExceeded):
            ctx.pread(path, 0, 256 * 1024, deadline_s=0.1)
    with StromContext(_cfg(StromConfig, fault_plan=plan,
                           io_retries=0)) as ctx:
        with pytest.raises(EngineError) as ei:
            ctx.pread(path, 0, 256 * 1024, deadline_s=5.0)
        assert not isinstance(ei.value, DeadlineExceeded)
