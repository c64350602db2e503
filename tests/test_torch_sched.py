"""The port's I/O scheduler against the JAX package's.

Under the reference tests' fake clock, the same scripted waiters give the
same grant order (priority classes, weights, idle baselines, throttled
tenants), the same per-tenant rows and the same counters in both packages;
``iter_slices`` cuts equal slices; ``TokenBucket`` and ``AdmissionGate``
behave the same. Then the port alone, with threads: grants are exclusive
on an exclusive engine and not on a concurrent one, ``held_by_me`` and
``engine_idle`` answer as the spill route needs, and the sliced gather
and scatter move exactly the bytes the engine alone would."""

import threading
import time

import numpy as np
import pytest

from strom.config import StromConfig as RefConfig
from strom.sched.budget import AdmissionGate as RefGate
from strom.sched.budget import TokenBucket as RefBucket
from strom.sched.scheduler import SCHED_FIELDS as REF_SCHED_FIELDS
from strom.sched.scheduler import IoScheduler as RefScheduler
from strom.sched.scheduler import _Waiter as RefWaiter
from strom.sched.tenant import PRIORITIES as REF_PRIORITIES
from strom.sched.tenant import PRIORITY_ORDER as REF_ORDER
from strom_torch.config import StromConfig
from strom_torch.sched import (PRIORITIES, SCHED_FIELDS, AdmissionGate,
                               IoScheduler, TokenBucket)
from strom_torch.sched.scheduler import _Waiter
from strom_torch.sched.tenant import PRIORITY_ORDER


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class StubEngine:
    """Counts bytes; read_vectored/write_vectored sleep per byte."""

    name = "stub"

    def __init__(self, s_per_byte: float = 0.0, concurrent: bool = False):
        self.s_per_byte = s_per_byte
        self.concurrent_gathers = concurrent
        self.calls: list = []
        self.scopes: list = []
        self.busy = 0
        self.max_busy = 0
        self._lock = threading.Lock()

    def _run(self, chunks) -> int:
        n = sum(ln for (_, _, _, ln) in chunks)
        with self._lock:
            self.busy += 1
            self.max_busy = max(self.max_busy, self.busy)
        if self.s_per_byte:
            time.sleep(n * self.s_per_byte)
        with self._lock:
            self.busy -= 1
            self.calls.append(n)
        return n

    def read_vectored(self, chunks, dest, *, retries=1):
        return self._run(chunks)

    def write_vectored(self, chunks, src, *, retries=1):
        return self._run(chunks)

    def set_scope(self, scope):
        self.scopes.append(scope)


SIDES = {
    "ref": (RefScheduler, RefConfig, RefWaiter, REF_ORDER),
    "port": (IoScheduler, StromConfig, _Waiter, PRIORITY_ORDER),
}


def _mk(side, clk, **cfg):
    sched_cls, cfg_cls, _, _ = SIDES[side]
    return sched_cls(StubEngine(), cfg_cls(sched_enabled=True, **cfg),
                     clock=clk)


def _enqueue(side, sched, tenant, nbytes, priority=None):
    """Queue a waiter without a thread (the scheduler's own enqueue)."""
    _, _, waiter_cls, order = SIDES[side]
    t = sched.resolve(tenant)
    w = waiter_cls(t, nbytes, order[priority or t.priority], sched._clock())
    with sched._cond:
        sched._enqueue_locked(w)
    return w


def _drain(sched) -> list:
    """Dispatch and release until nothing is grantable: the grant order."""
    order = []
    with sched._cond:
        while True:
            sched._dispatch_locked()
            w = sched._current
            if w is None:
                break
            order.append((w.tenant.name, w.nbytes))
            w.tenant.active -= 1
            sched._current = None
    return order


def _rows(sched) -> dict:
    rows = sched.tenants_info()["tenants"]
    keep = ("priority", "weight", "queued_ops", "queued_bytes",
            "active_grants", "granted_ops", "granted_bytes",
            "throttle_waits", "byte_budget", "iops_budget")
    return {n: {k: r[k] for k in keep} for n, r in rows.items()}


# each scenario: (registrations, [steps]); a step is ("q", tenant, nbytes
# [, priority]), ("drain",) or ("tick", seconds)
SCENARIOS = {
    "strict_priority": (
        [("bg", {"priority": "background"}), ("train", {}),
         ("live", {"priority": "interactive"})],
        [("q", "bg", 100), ("q", "train", 100), ("q", "live", 100),
         ("q", "bg", 100), ("q", "live", 100), ("drain",)]),
    "weighted_fair": (
        [("heavy", {"weight": 2}), ("light", {"weight": 1})],
        [("q", "heavy", 100)] * 8 + [("q", "light", 100)] * 4
        + [("drain",)]),
    "light_behind_greedy": (
        [("greedy", {}), ("light", {})],
        [("q", "greedy", 1000)] * 6 + [("q", "light", 10), ("drain",)]),
    "idle_baseline": (
        [("a", {}), ("b", {})],
        [("q", "a", 100)] * 4 + [("drain",)]
        + [("q", "a", 100), ("q", "b", 100)] * 3 + [("drain",)]),
    "throttled_class_yields": (
        [("live", {"priority": "interactive", "byte_rate": 1_000_000,
                   "byte_burst": 100}),
         ("bg", {"priority": "background"})],
        [("q", "live", 100)] * 3 + [("q", "bg", 100)] * 4
        + [("drain",), ("tick", 1.0), ("drain",), ("tick", 1.0),
           ("drain",)]),
    "iops_budget": (
        [("ops", {"iops": 2}), ("free", {})],
        [("q", "ops", 10)] * 5 + [("q", "free", 50)] * 2
        + [("drain",), ("tick", 0.5), ("drain",), ("tick", 0.5),
           ("drain",), ("tick", 2.0), ("drain",)]),
    "priority_override": (
        [("t", {}), ("u", {"weight": 3})],
        [("q", "t", 64, "background"), ("q", "u", 64), ("q", "t", 64),
         ("q", "u", 64, "interactive"), ("q", "t", 64), ("drain",)]),
    "auto_registered": (
        [],
        [("q", "x", 5), ("q", None, 7), ("q", "y", 5), ("q", "x", 5),
         ("drain",)]),
    "debt_after_jumbo": (
        [("j", {"byte_rate": 1000, "byte_burst": 100}), ("k", {})],
        [("q", "j", 5000), ("q", "j", 10), ("q", "k", 10), ("drain",),
         ("tick", 3.0), ("drain",), ("tick", 2.5), ("drain",)]),
}


def _play(side, name):
    clk = FakeClock()
    sched = _mk(side, clk)
    regs, steps = SCENARIOS[name]
    for tname, kw in regs:
        sched.register(tname, **kw)
    trace = []
    for st in steps:
        if st[0] == "q":
            _enqueue(side, sched, st[1], st[2],
                     st[3] if len(st) > 3 else None)
        elif st[0] == "tick":
            clk.advance(st[1])
        else:
            trace.append(_drain(sched))
    return trace, _rows(sched), sched.stats()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_grant_order_equals_reference(name):
    got = _play("port", name)
    want = _play("ref", name)
    assert got == want
    assert any(got[0])   # the scenario granted something


def test_reference_orders_hold():
    """The contracts the scenarios encode, read off the port's traces."""
    order = [t for t, _ in _play("port", "strict_priority")[0][0]]
    assert order == ["live", "live", "train", "bg", "bg"]
    light = [t for t, _ in _play("port", "light_behind_greedy")[0][0]]
    assert "light" in light[:2]
    first, refill1, refill2 = _play("port", "throttled_class_yields")[0]
    assert [t for t, _ in first] == ["live"] + ["bg"] * 4
    assert [t for t, _ in refill1] == ["live"] == [t for t, _ in refill2]


@pytest.mark.parametrize("limit", [-1, 0, 1, 4096, 100_000, 1 << 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_iter_slices_equal_reference(limit, seed):
    rng = np.random.default_rng(seed)
    chunks = [(int(rng.integers(3)), int(rng.integers(1 << 30)),
               int(rng.integers(1 << 30)), int(rng.integers(1, 300_000)))
              for _ in range(200)]
    got = list(IoScheduler(StubEngine(), StromConfig(
        sched_slice_bytes=limit, queue_depth=8,
        block_size=4096)).iter_slices(chunks))
    want = list(RefScheduler(StubEngine(), RefConfig(
        sched_slice_bytes=limit, queue_depth=8,
        block_size=4096)).iter_slices(chunks))
    assert got == want
    assert [c for sl in got for c in sl] == chunks


def test_slice_override_and_auto_match_reference():
    for cls, cfg in ((IoScheduler, StromConfig), (RefScheduler, RefConfig)):
        s = cls(StubEngine(), cfg(queue_depth=32, block_size=128 * 1024))
        assert s._slice_bytes() == 16 * 1024 * 1024
        s.slice_bytes_override = 4096
        assert s._slice_bytes() == 4096


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_equals_reference(seed):
    rng = np.random.default_rng(seed)
    rate, burst = (float(rng.integers(0, 3) * 500),
                   float(rng.integers(50, 500))) if seed else (100.0, 50.0)
    outs = []
    for cls in (RefBucket, TokenBucket):
        clk = FakeClock()
        b = cls(rate, burst, clock=clk)
        r = np.random.default_rng(seed + 10)
        trace = []
        for _ in range(200):
            op = int(r.integers(3))
            n = float(r.integers(1, 800))
            if op == 0:
                trace.append(("peek", round(b.peek(n), 9)))
            elif op == 1:
                b.take(n)
                trace.append(("take", round(b.tokens, 6)))
            else:
                clk.advance(float(r.random()))
        trace.append(b.state())
        outs.append(trace)
    assert outs[1] == outs[0]


class FakePool:
    def __init__(self, max_bytes=1000):
        self.max_bytes = max_bytes
        self.in_use_bytes = 0
        self.hooks = []

    def add_change_hook(self, fn):
        self.hooks.append(fn)

    def set_in_use(self, n):
        self.in_use_bytes = n
        for fn in self.hooks:
            fn()


@pytest.mark.parametrize("high_water", [0.0, 0.5, 0.9, 1.0])
def test_admission_gate_equals_reference(high_water):
    outs = []
    for cls in (RefGate, AdmissionGate):
        pool = FakePool(1000)
        g = cls(pool, high_water)
        trace = [g.enabled]
        for in_use, ask in ((0, 100), (800, 100), (850, 100), (100, 2000),
                            (0, 5000), (999, 1)):
            pool.set_in_use(in_use)
            trace.append((g.has_room(ask), g.admit(ask, timeout_s=0.01)))
        trace.append(g.state())
        outs.append(trace)
    assert outs[1] == outs[0]


def test_admission_waits_until_the_pool_releases():
    pool = FakePool(1000)
    g = AdmissionGate(pool, 0.9)
    pool.set_in_use(850)
    done = threading.Event()
    ok = []
    t = threading.Thread(target=lambda: (ok.append(g.admit(
        100, timeout_s=10.0)), done.set()), daemon=True)
    t.start()
    assert not done.wait(0.1)
    pool.set_in_use(100)   # the pool's hook wakes the gate
    assert done.wait(5.0) and ok == [True] and g.waits == 1


def test_admission_gate_disabled_without_pool():
    assert AdmissionGate(None, 0.9).admit(1 << 40)


def test_names_equal_reference():
    assert SCHED_FIELDS == REF_SCHED_FIELDS
    assert PRIORITIES == REF_PRIORITIES


def test_register_returns_the_live_tenant_and_scopes_it():
    from strom_torch.utils.stats import StatsRegistry

    reg = StatsRegistry("t")
    s = IoScheduler(StubEngine(), StromConfig(), scope=reg)
    t = s.register("a", priority="interactive", weight=2)
    assert s.register("a", priority="background") is t
    assert t.priority == "interactive" and t.scope.labels == {"tenant": "a"}
    assert s.tenant(None).scope is reg
    with pytest.raises(ValueError):
        s.register("bad", priority="urgent")
    with pytest.raises(ValueError):
        s.register("bad", weight=0)


# -- threads, on the port ------------------------------------------------
def test_exclusive_grants_serialize_and_count_per_tenant():
    from strom_torch.utils.stats import StatsRegistry

    eng = StubEngine(s_per_byte=1e-6)
    reg = StatsRegistry("t")
    s = IoScheduler(eng, StromConfig(sched_slice_bytes=1000), scope=reg)
    chunks = [(0, i * 500, i * 500, 500) for i in range(20)]

    def run(name):
        assert s.read_chunks(chunks, None, tenant=name) == 10_000

    ths = [threading.Thread(target=run, args=(n,)) for n in ("a", "b", "c")]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert eng.max_busy == 1
    assert sum(eng.calls) == 30_000 and len(eng.calls) == 30
    for n in ("a", "b", "c"):
        snap = s.tenant(n).scope.snapshot()
        assert snap["sched_granted_bytes"] == 10_000
        assert snap["sched_granted_ops"] == 10
        assert snap["sched_queue_wait_count"] == 10
    st = s.stats()
    assert st["sched_granted_bytes"] == 30_000 and st["sched_exclusive"]
    assert st["sched_active_grants"] == 0
    # an exclusive grant steers the engine's scope to the tenant and back
    assert any(getattr(sc, "labels", {}).get("tenant") for sc in eng.scopes)
    assert eng.scopes[-1] is reg


def test_concurrent_engine_grants_do_not_serialize():
    eng = StubEngine(s_per_byte=2e-5, concurrent=True)
    s = IoScheduler(eng, StromConfig(sched_slice_bytes=0))
    assert not s.exclusive and s.engine_idle()
    barrier = threading.Barrier(3)

    def run():
        barrier.wait()
        s.read_chunks([(0, 0, 0, 5000)], None, tenant="t")

    ths = [threading.Thread(target=run) for _ in range(3)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert eng.max_busy > 1
    assert s.tenant("t").granted_bytes == 15_000


def test_held_by_me_and_engine_idle():
    s = IoScheduler(StubEngine(), StromConfig())
    assert not s.held_by_me() and s.engine_idle()
    other = []
    with s.grant("a", 10):
        assert s.held_by_me() and not s.engine_idle()
        th = threading.Thread(target=lambda: other.append(
            (s.held_by_me(), s.engine_idle())))
        th.start()
        th.join()
    assert other == [(False, False)]
    assert not s.held_by_me() and s.engine_idle()


def test_release_on_another_thread_refunds_the_acquirer():
    s = IoScheduler(StubEngine(), StromConfig())
    w = s.acquire("a", 1)
    th = threading.Thread(target=s.release, args=(w,))
    th.start()
    th.join()
    assert not s.held_by_me() and s.engine_idle()
    assert s.drain("a", timeout_s=1.0) and s.drain_all(1.0) == []


def test_write_chunks_slices_like_reads():
    eng = StubEngine()
    s = IoScheduler(eng, StromConfig(sched_slice_bytes=1000))
    chunks = [(0, i * 400, i * 400, 400) for i in range(10)]
    assert s.write_chunks(chunks, None, tenant="w") == 4000
    assert eng.calls == [1200, 1200, 1200, 400]
    assert s.tenant("w").granted_ops == 4


def test_interactive_waits_one_slice_not_a_backlog():
    """A greedy tenant loops over a long sliced gather; an interactive
    tenant's grants each wait behind at most a slice or two, never the
    greedy gather (100 slices of 4 ms)."""
    eng = StubEngine(s_per_byte=4e-6)
    s = IoScheduler(eng, StromConfig(sched_slice_bytes=1000))
    s.register("greedy")
    s.register("live", priority="interactive")
    chunks = [(0, 0, i * 1000, 1000) for i in range(100)]
    stop = threading.Event()

    def greedy():
        while not stop.is_set():
            s.read_chunks(chunks, None, tenant="greedy")

    g = threading.Thread(target=greedy, daemon=True)
    g.start()
    time.sleep(0.02)
    waits = []
    try:
        for _ in range(5):
            t0 = time.monotonic()
            with s.grant("live", 10):
                pass
            waits.append(time.monotonic() - t0)
            time.sleep(0.005)
    finally:
        stop.set()
        g.join(timeout=10)
    assert s.tenant("live").granted_ops == 5
    # the greedy gather is 0.4 s; a slice is 4 ms
    assert max(waits) < 0.2, waits
