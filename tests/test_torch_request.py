"""Request tracing and the event ring of the port, beside the JAX
package's: request ids, nesting (an enclosing request wins), ``attach``
across threads, deadlines (first writer wins), the finish-time registry
counters and observers, and the ring's snapshot shape, event for event."""

import threading

import pytest

from strom.obs import events as jev
from strom.obs import request as jreq
from strom_torch.obs import events as tev
from strom_torch.obs import request as treq
from strom_torch.utils.stats import global_stats

MODS = [pytest.param(jreq, jev, id="jax_package"),
        pytest.param(treq, tev, id="port")]


def _script(req_mod, ring):
    """One fixed sequence of ring and request emissions."""
    ring.instant("boot", cat="meta", args={"n": 1})
    with ring.span("outer", cat="read", args={"ops": 2}):
        ring.flow("s", 7, "f")
    with req_mod.active("gather", "t0") as req:
        with req_mod.span("plan", cat="read"):
            with req_mod.span("slice", cat="read", args={"slice": 0}):
                pass
        req_mod.complete(1.0, 2.0, "cache", "serve", {"bytes": 3})
        req.note_queue_wait(5.0, throttled=True)
    with req_mod.span("plain", cat="put"):
        pass
    return req


def _shape(ev: dict, req_ids: dict) -> tuple:
    args = dict(ev.get("args") or {})
    for k in ("req",):
        if k in args:
            args[k] = req_ids.setdefault(args[k], len(req_ids))
    args.pop("dur_us", None)
    if ev["ph"] in "stf":
        ev = dict(ev, id=req_ids.setdefault(ev["id"], len(req_ids)))
    return (ev["ph"], ev["cat"], ev["name"], ev.get("id"),
            tuple(sorted((k, v) for k, v in args.items())),
            "dur_us" in ev)


def test_ring_snapshot_shape_matches():
    shapes = []
    for req_mod, ev_mod in ((jreq, jev), (treq, tev)):
        ring = ev_mod.EventRing(capacity=8)
        ev_mod_ring, req_mod.ring = req_mod.ring, ring
        try:
            _script(req_mod, ring)
        finally:
            req_mod.ring = ev_mod_ring
        snap = ring.snapshot()
        assert snap[0]["name"] == "events_dropped"
        ids: dict = {}
        # order by name within equal timestamps: the clocks differ
        shapes.append(sorted(_shape(e, ids) for e in snap))
        assert ring.events_written > ring.capacity
        assert ring.high_water == ring.capacity == len(ring)
        assert ring.events_dropped == ring.events_written - ring.capacity
    assert shapes[0] == shapes[1]


def test_ring_counts_and_clear():
    for ev_mod in (jev, tev):
        ring = ev_mod.EventRing(capacity=4)
        for i in range(6):
            ring.instant(f"e{i}")
        assert (ring.events_written, ring.events_dropped, len(ring)) \
            == (6, 2, 4)
        ring.clear()
        assert (len(ring), ring.snapshot()) == (0, [])
        ring.enabled = False
        ring.instant("off")
        with ring.span("off"):
            pass
        assert len(ring) == 0
        with pytest.raises(ValueError):
            ev_mod.EventRing(capacity=0)


@pytest.mark.parametrize("req_mod,ev_mod", MODS)
def test_ids_nesting_and_span_tree(req_mod, ev_mod):
    with req_mod.active("step", "t1") as outer:
        assert req_mod.current() is outer
        with req_mod.active("gather", "t2") as inner:
            assert inner is outer    # the enclosing request wins
            with req_mod.span("a"):
                with req_mod.span("b"):
                    assert outer.parent_of() == "b"
    assert req_mod.current() is None
    names = [(n, p) for (n, _c, _ts, _d, _tid, p) in outer.spans]
    assert names == [("b", "a"), ("a", None)]
    with req_mod.active("gather") as nxt:
        pass
    assert nxt.id > outer.id and nxt.tenant == "default"
    doc = outer.to_doc()
    assert set(doc) == {"req", "kind", "tenant", "t0_us", "dur_us",
                        "queue_wait_us", "throttled", "error",
                        "spans_dropped", "spans"}


@pytest.mark.parametrize("req_mod,ev_mod", MODS)
def test_attach_across_threads(req_mod, ev_mod):
    seen = {}
    with req_mod.active("gather", "t3") as req:
        def work():
            seen["before"] = req_mod.current()
            with req_mod.attach(req):
                seen["inside"] = req_mod.current()
                with req_mod.span("pump"):
                    pass
            seen["after"] = req_mod.current()

        th = threading.Thread(target=work)
        th.start()
        th.join()
    assert seen == {"before": None, "inside": req, "after": None}
    assert [s[0] for s in req.spans] == ["pump"]
    with req_mod.attach(None) as nothing:
        assert nothing is None


@pytest.mark.parametrize("req_mod,ev_mod", MODS)
def test_deadline_first_writer_wins(req_mod, ev_mod):
    r = req_mod.Request("gather")
    r.set_deadline_s(None)
    r.set_deadline_s(0)
    assert r.deadline is None
    r.set_deadline_s(10.0)
    d = r.deadline
    r.set_deadline_s(0.001)
    assert r.deadline == d


def test_finish_feeds_the_registry_and_observers():
    seen = []
    treq.add_observer(seen.append)
    treq.add_observer(seen.append)   # registered once
    try:
        before = {k: global_stats.counter(k).value
                  for k in ("req_total", "req_throttled", "req_errors")}
        lat0 = global_stats.histogram("req_lat").count
        with pytest.raises(RuntimeError):
            with treq.active("gather", "tq") as req:
                req.note_queue_wait(10.0, throttled=True)
                raise RuntimeError("boom")
        with treq.active("step"):
            pass
        with pytest.raises(StopIteration):
            with treq.active("gather"):
                raise StopIteration
        req.finish()                  # idempotent
        after = {k: global_stats.counter(k).value for k in before}
        assert after["req_total"] - before["req_total"] == 3
        assert after["req_throttled"] - before["req_throttled"] == 1
        assert after["req_errors"] - before["req_errors"] == 1
        # a step request's wall is the consumer's compute: no req_lat
        assert global_stats.histogram("req_lat").count - lat0 == 2
        assert req.error == "RuntimeError: boom"
        assert len(seen) == 3 and seen[0] is req
        scoped = global_stats.scoped(tenant="tq").counter("req_total")
        assert scoped.value >= 1
    finally:
        treq.remove_observer(seen.append)
    assert seen.append not in treq._observers
