"""Fault plans, FaultyEngine and the resilience primitives of the port,
held to the JAX package's on the same seeded inputs: the same plan and
seed give the same decision sequence for every rule kind and matcher, a
FaultyEngine over a seeded file gives the same completions, the errno
classes and field tuples are equal, RetryPolicy's delays are equal under
the same RNG state, the per-gather budget stops a retry storm, the
CircuitBreaker walks the same lifecycle under a fake clock, and the
HedgeController's thresholds agree."""

import errno
import json
import random
import time

import numpy as np
import pytest

from strom.engine import resilience as jres
from strom.engine.python_engine import PythonEngine as JPythonEngine
from strom.faults import FaultPlan as JPlan
from strom.faults import FaultRule as JRule
from strom.faults import FaultyEngine as JFaulty
from strom.config import StromConfig as JConfig
from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.engine import resilience as tres
from strom_torch.engine.python_engine import PythonEngine
from strom_torch.faults import FaultPlan, FaultRule, FaultyEngine

MiB = 1 << 20

# every rule kind and every matcher, in rules the same op stream hits
RULE_SETS = {
    "errno": [{"kind": "errno", "p": 0.3, "err": "EIO"}],
    "short_read": [{"kind": "short_read", "every": 3, "short_frac": 0.25}],
    "bit_flip": [{"kind": "bit_flip", "p": 0.4}],
    "latency": [{"kind": "latency", "p": 0.5, "latency_s": 0.01}],
    "stuck": [{"kind": "stuck", "every": 5, "release_s": 0.2}],
    "engine_death": [{"kind": "engine_death", "op_lo": 30}],
    "hangup": [{"kind": "hangup", "p": 0.2}],
    "path": [{"kind": "errno", "path": "shard1"}],
    "tenant": [{"kind": "errno", "tenant": "t1", "p": 0.5}],
    "op": [{"kind": "errno", "op": "write", "p": 0.5},
           {"kind": "bit_flip", "p": 0.5}],
    "offsets": [{"kind": "short_read", "offset_lo": MiB,
                 "offset_hi": 2 * MiB}],
    "op_window": [{"kind": "errno", "op_lo": 10, "op_hi": 40, "p": 0.5}],
    "every": [{"kind": "errno", "every": 4}],
    "times": [{"kind": "errno", "p": 0.5, "times": 5}],
    "mixed": [{"kind": "errno", "p": 0.05, "times": 6},
              {"kind": "short_read", "p": 0.05, "short_frac": 0.5},
              {"kind": "latency", "p": 0.2, "latency_s": 0.002,
               "op": "read"}],
}

OPS = [(f"/data/shard{i % 3}.bin", (i * 7919) % (4 * MiB), 128 * 1024,
        ("t0", "t1", None)[i % 3], "write" if i % 7 == 0 else "read")
       for i in range(300)]


def _decisions(plan, ops=OPS):
    out = []
    for path, off, ln, tenant, op in ops:
        f = plan.decide(path=path, offset=off, length=ln, tenant=tenant,
                        op=op)
        out.append(None if f is None else
                   (f.kind, f.rule_index, f.err, f.keep_bytes,
                    f.flip_offset, f.flip_mask, f.latency_s, f.release_s))
    return out


@pytest.mark.parametrize("name", sorted(RULE_SETS))
@pytest.mark.parametrize("seed", [0, 7])
def test_same_plan_same_decisions_in_both_packages(name, seed):
    doc = json.dumps({"seed": seed, "rules": RULE_SETS[name]})
    jp, tp = JPlan.from_spec(doc), FaultPlan.from_spec(doc)
    got, want = _decisions(tp), _decisions(jp)
    assert got == want
    assert tp.stats() == jp.stats()
    if name not in ("path", "tenant"):
        assert any(d is not None for d in got), "the plan must fire"


@pytest.mark.parametrize("preset", ["chaos", "chaos:3", "chaos_writes:1",
                                    "chaos_net:2"])
def test_presets_decide_alike(preset):
    jp, tp = JPlan.from_spec(preset), FaultPlan.from_spec(preset)
    assert [dataclass_tuple(r) for r in tp.rules] == \
        [dataclass_tuple(r) for r in jp.rules]
    assert _decisions(tp) == _decisions(jp)


def dataclass_tuple(rule):
    import dataclasses

    return tuple(dataclasses.astuple(rule))


def test_unwind_and_spec_errors_match():
    for Plan, Rule in ((JPlan, JRule), (FaultPlan, FaultRule)):
        plan = Plan([Rule("errno", times=1)], seed=0)
        f = plan.decide(path="p", offset=0, length=64)
        assert plan.decide(path="p", offset=0, length=64) is None
        plan.unwind(f)
        assert plan.stats()["faults_injected"] == 0
        assert plan.decide(path="p", offset=0, length=64).kind == "errno"
        with pytest.raises(ValueError):
            Plan.from_spec("no-such-preset")
        with pytest.raises(ValueError):
            Rule("gamma_ray")
        with pytest.raises(ValueError):
            Rule("errno", op="sideways")


def test_from_spec_file(tmp_path):
    doc = {"seed": 3, "rules": [{"kind": "errno", "err": "ENXIO"}]}
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(doc))
    tp = FaultPlan.from_spec(str(p))
    assert tp.seed == 3 and tp.rules[0].err == errno.ENXIO
    assert FaultPlan.from_spec(json.dumps(doc)).rules == tp.rules


def test_errno_classes_and_field_tuples_equal():
    assert tres.TRANSIENT_ERRNOS == jres.TRANSIENT_ERRNOS
    assert tres.PERMANENT_ERRNOS == jres.PERMANENT_ERRNOS
    assert tres.RESILIENCE_FIELDS == jres.RESILIENCE_FIELDS
    assert tres.CHAOS_BENCH_FIELDS == jres.CHAOS_BENCH_FIELDS
    for e in list(range(-140, 141)) + [12345]:
        assert tres.classify_errno(e) == jres.classify_errno(e), e


# -- FaultyEngine over a seeded file ------------------------------------------
ENGINE_PLANS = {
    "errno": [{"kind": "errno", "p": 0.3, "times": 4}],
    "short_read": [{"kind": "short_read", "every": 3, "times": 3}],
    "bit_flip": [{"kind": "bit_flip", "times": 2}],
    "latency": [{"kind": "latency", "p": 0.5, "latency_s": 0.002}],
    "permanent": [{"kind": "errno", "err": "EBADF"}],
    "death": [{"kind": "engine_death", "op_lo": 3}],
}


def _engine_run(faulty_cls, engine_cls, config_cls, path, plan_doc, nbytes):
    cfg = config_cls(engine="python", queue_depth=1, num_buffers=8,
                     io_retry_backoff_s=0.0005,
                     io_retry_backoff_max_s=0.001, io_retry_budget=8,
                     residency_hybrid=False)
    plan_cls = JPlan if faulty_cls is JFaulty else FaultPlan
    eng = faulty_cls(engine_cls(cfg), plan_cls.from_spec(plan_doc))
    try:
        fi = eng.register_file(path)
        dest = alloc_aligned(nbytes)
        try:
            n = eng.read_vectored([(fi, 0, 0, nbytes)], dest, retries=3)
            err = None
        except OSError as e:   # either package's EngineError
            n, err = None, e.errno
        return n, err, dest.copy(), eng.plan.stats()
    finally:
        eng.close()


@pytest.mark.parametrize("name", sorted(ENGINE_PLANS))
def test_faulty_engine_completions_match(name, data_file):
    """Queue depth 1 makes the op stream a pure function of the plan, so
    both proxies see the same ops, decide the same faults, and end with
    the same bytes, result and tallies."""
    path, golden = data_file
    doc = json.dumps({"seed": 5, "rules": ENGINE_PLANS[name]})
    nbytes = MiB
    jn, jerr, jdest, jst = _engine_run(JFaulty, JPythonEngine, JConfig,
                                       path, doc, nbytes)
    tn, terr, tdest, tst = _engine_run(FaultyEngine, PythonEngine,
                                       StromConfig, path, doc, nbytes)
    assert (tn, terr) == (jn, jerr)
    np.testing.assert_array_equal(tdest, jdest)
    assert tst == jst
    if name in ("errno", "short_read", "latency"):
        assert tn == nbytes
        np.testing.assert_array_equal(tdest, golden[:nbytes])
    if name == "bit_flip":
        assert int((tdest != golden[:nbytes]).sum()) == 2
    if name == "permanent":
        assert terr == errno.EBADF and tst["ops_seen"] == 1


def test_stuck_released_by_cancel(data_file):
    path, _ = data_file
    cfg = StromConfig(engine="python", queue_depth=8, num_buffers=8)
    eng = FaultyEngine(PythonEngine(cfg),
                       FaultPlan([FaultRule("stuck")], seed=0))
    try:
        fi = eng.register_file(path)
        dest = alloc_aligned(64 * 1024)
        tok = eng.submit_vectored([(fi, 0, 0, 64 * 1024)], dest, retries=0)
        assert eng.poll(tok, min_completions=1, timeout_s=0.2) == []
        eng.cancel(tok, timeout_s=2.0)
        assert eng.in_flight() == 0
        assert eng.release_stuck() == 0
    finally:
        eng.close()


def test_latency_delays_but_delivers(data_file):
    path, golden = data_file
    cfg = StromConfig(engine="python", queue_depth=8, num_buffers=8)
    eng = FaultyEngine(PythonEngine(cfg), FaultPlan(
        [FaultRule("latency", latency_s=0.05, times=1)], seed=0))
    try:
        fi = eng.register_file(path)
        dest = alloc_aligned(128 * 1024)
        t0 = time.monotonic()
        assert eng.read_vectored([(fi, 0, 0, 128 * 1024)], dest) \
            == 128 * 1024
        assert time.monotonic() - t0 >= 0.045
        np.testing.assert_array_equal(dest, golden[:128 * 1024])
        assert eng.stats()["faults"]["by_kind"] == {"latency": 1}
    finally:
        eng.close()


# -- RetryPolicy ----------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"backoff_s": 0.01, "backoff_max_s": 0.05,
                                     "jitter": 0.0},
                                {"backoff_s": 0.002, "jitter": 0.5,
                                 "seed": 99}])
def test_retry_delays_equal(kw):
    a, b = jres.RetryPolicy(**kw), tres.RetryPolicy(**kw)
    for attempts in [0, 1, 2, 3, 5, 8, 0, 1] * 4:
        assert b.delay_s(attempts) == a.delay_s(attempts)
    cfg = StromConfig(io_retry_backoff_s=0.003, io_retry_backoff_max_s=0.07,
                      io_retry_budget=9)
    p = tres.RetryPolicy.from_config(cfg)
    assert (p.backoff_s, p.backoff_max_s, p.budget) == (0.003, 0.07, 9)
    rng = random.Random(0xC0FFEE)
    q = tres.RetryPolicy(backoff_s=0.01, backoff_max_s=1.0, jitter=0.25)
    for attempts in range(4):
        want = 0.01 * 2 ** attempts * (1.0 + 0.25 * rng.random())
        assert q.delay_s(attempts) == pytest.approx(want)


def test_should_retry_gates_match():
    for pol in (jres.RetryPolicy(budget=2), tres.RetryPolicy(budget=2)):
        assert pol.should_retry(errno.EIO, 0, 3, 0)
        assert not pol.should_retry(errno.EBADF, 0, 3, 0)
        assert not pol.should_retry(errno.EIO, 3, 3, 0)
        assert not pol.should_retry(errno.EIO, 0, 3, 2)


def test_gather_budget_bounds_retry_storm(data_file):
    """A persistently failing extent stops at the per-gather budget in both
    packages: 1 original op plus exactly budget resubmits reach the plan."""
    path, _ = data_file
    for faulty_cls, engine_cls, config_cls, plan_cls, rule_cls in (
            (JFaulty, JPythonEngine, JConfig, JPlan, JRule),
            (FaultyEngine, PythonEngine, StromConfig, FaultPlan, FaultRule)):
        cfg = config_cls(engine="python", queue_depth=8, num_buffers=8,
                         io_retry_backoff_s=0.001,
                         io_retry_backoff_max_s=0.004, io_retry_budget=3)
        eng = faulty_cls(engine_cls(cfg), plan_cls([rule_cls("errno")],
                                                   seed=0))
        try:
            fi = eng.register_file(path)
            with pytest.raises(OSError):   # either package's EngineError
                eng.read_vectored([(fi, 0, 0, 64 * 1024)],
                                  alloc_aligned(64 * 1024), retries=100)
            assert eng.plan.stats()["ops_seen"] == 4
        finally:
            eng.close()


# -- CircuitBreaker under a fake clock ------------------------------------------
def _breakers(**kw):
    now = [0.0]
    kw = {"window_s": 10.0, "min_events": 4, "error_rate": 0.5,
          "cooldown_s": 5.0, "half_open_successes": 2, **kw}
    return now, [mod.CircuitBreaker(clock=lambda: now[0], **kw)
                 for mod in (jres, tres)]


def _both(brs, fn):
    out = [fn(b) for b in brs]
    assert out[0] == out[1], out
    return out[1]


SCRIPTS = {
    "trip_half_open_recover": ["s", "s", "s", "f", "f", "f", "f", "a",
                               ("t", 5.1), "a", "s", "s", "a"],
    "failed_probe": ["f", "f", "f", "f", ("t", 5.1), "a", "f", "a",
                     ("t", 4.0), "a", ("t", 1.2), "a", "s", "s"],
    "window_prune": ["f", "f", "f", ("t", 11.0), "s", "s", "s", "s", "f",
                     "a"],
    "below_min_events": ["f", "f", "f", "a", "s", "f", "a"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_lifecycle_matches(name):
    now, brs = _breakers()
    trips = [[], []]
    for b, t in zip(brs, trips):
        b.on_trip = t.append
    for step in SCRIPTS[name]:
        if isinstance(step, tuple):
            now[0] += step[1]
        elif step == "s":
            _both(brs, lambda b: b.record_success())
        elif step == "f":
            _both(brs, lambda b: b.record_failure())
        else:
            _both(brs, lambda b: b.allow())
        _both(brs, lambda b: b.state)
        _both(brs, lambda b: b.info())
    assert trips[0] == trips[1]
    if name == "trip_half_open_recover":
        assert brs[1].state == tres.CircuitBreaker.CLOSED
        assert (brs[1].trips, brs[1].recoveries) == (1, 1)
    if name == "failed_probe":
        assert brs[1].trips == 2
    if name == "window_prune":
        assert brs[1].state == tres.CircuitBreaker.CLOSED


# -- HedgeController ----------------------------------------------------------
@pytest.mark.parametrize("kw,samples", [
    ({"min_s": 0.05, "multiplier": 3.0}, [10.0] * 7),
    ({"min_s": 0.001, "multiplier": 2.0}, [0.01] * 128),
    ({"min_s": 0.0, "multiplier": 3.0, "window": 32},
     [0.001 * (i % 17) for i in range(200)]),
])
def test_hedge_thresholds_match(kw, samples):
    a, b = jres.HedgeController(**kw), tres.HedgeController(**kw)
    for i, x in enumerate(samples):
        a.observe(x)
        b.observe(x)
        if i % 5 == 0:
            assert b.threshold_s() == a.threshold_s()
    assert b.threshold_s() == a.threshold_s()
