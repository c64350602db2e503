"""The ring's readers in the port, held to the JAX package's on the same
seeded inputs (all compare exactly): stall attribution
(``obs/stall.py``), Chrome traces (``obs/chrome_trace.py``) and exemplar
retention (``obs/exemplars.py``) over the same synthetic events and
requests; and a seeded loader run on the CPU, whose spans carry the JAX
package's names and categories and whose ``stats()["steps"]`` has every
bucket."""

import json
import time

import numpy as np
import pytest

from strom.obs import chrome_trace as j_chrome
from strom.obs import stall as j_stall
from strom.obs.exemplars import EXEMPLAR_FIELDS as J_EXEMPLAR_FIELDS
from strom.obs.exemplars import ExemplarStore as JExemplarStore
from strom_torch.obs import chrome_trace, stall
from strom_torch.obs.events import EventRing, ring
from strom_torch.obs.exemplars import EXEMPLAR_FIELDS, ExemplarStore


def _events(seed: int, steps: int = 12) -> list[dict]:
    """A seeded synthetic timeline: a consumer thread alternating
    ingest_wait spans and compute (with explicit step spans on odd seeds),
    worker threads' decode / put / read spans overlapping the waits,
    instants and a flow chain."""
    rng = np.random.default_rng(seed)
    out: list[dict] = []
    t = 1000.0
    for i in range(steps):
        wait = float(rng.uniform(0, 3000))
        comp = float(rng.uniform(500, 4000))
        if seed % 2:
            out.append({"ph": "X", "name": "train.step", "cat": "step",
                        "ts_us": t, "dur_us": wait + comp, "tid": 1,
                        "args": {"step": i}})
        out.append({"ph": "X", "name": "pipeline.next", "cat": "ingest_wait",
                    "ts_us": t, "dur_us": wait, "tid": 1,
                    "args": {"step": i}})
        for cat, tid in (("decode", 2), ("put", 3), ("read", 4)):
            lo = t + float(rng.uniform(-1000, wait + 500))
            out.append({"ph": "X", "name": f"w.{cat}", "cat": cat,
                        "ts_us": lo, "dur_us": float(rng.uniform(0, 2000)),
                        "tid": tid, "args": None})
        out.append({"ph": "i", "name": "prefetch.state", "cat": "prefetch",
                    "ts_us": t + wait, "tid": 5, "args": {"state": "ready"}})
        t += wait + comp
    for k, ph in enumerate(("s", "t", "f")):
        out.append({"ph": ph, "name": "req", "cat": "req", "id": 7,
                    "ts_us": 1500.0 + k, "tid": 6, "args": None})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stall_attribution_matches_reference(seed):
    evs = _events(seed)
    assert stall.BUCKETS == j_stall.BUCKETS
    assert stall.STALL_FIELDS == j_stall.STALL_FIELDS
    for lo in (None, 5000.0):
        got = [b.__dict__ for b in stall.step_buckets(evs, lo_us=lo)]
        want = [b.__dict__ for b in j_stall.step_buckets(evs, lo_us=lo)]
        assert got == want
        s, js = stall.steps_summary(evs, lo_us=lo), \
            j_stall.steps_summary(evs, lo_us=lo)
        assert s == js
        assert stall.flatten_summary(s) == j_stall.flatten_summary(js)
    assert set(stall.flatten_summary(stall.steps_summary(evs))) \
        == set(stall.STALL_FIELDS)


@pytest.mark.parametrize("seed", [0, 1])
def test_chrome_trace_matches_reference(seed, tmp_path):
    evs = _events(seed)
    assert chrome_trace.to_trace_events(evs, pid=9) \
        == j_chrome.to_trace_events(evs, pid=9)
    meta = {"run": "parity"}
    assert chrome_trace.trace_document(evs, meta=meta) \
        == j_chrome.trace_document(evs, meta=meta)
    # two hosts tied by a clock-offset exchange, a third unreached
    hosts = {"a": evs[:20] + [{"ph": "i", "name": "peer.clock_offset",
                               "cat": "peer", "ts_us": 10.0, "tid": 1,
                               "args": {"peer": "b:1", "offset_us": 250.0}}],
             "b": evs[20:40] + [{"ph": "i", "name": "peer.self",
                                 "cat": "peer", "ts_us": 5.0, "tid": 1,
                                 "args": {"addr": "b:1"}}],
             "c": evs[40:]}
    assert chrome_trace._clock_shifts(hosts) == j_chrome._clock_shifts(hosts)
    assert chrome_trace.merge_host_traces(hosts, meta=meta) \
        == j_chrome.merge_host_traces(hosts, meta=meta)
    # a dumped ring loads back as the same event dicts in both packages
    r = EventRing(capacity=64)
    for e in evs[:30]:
        if e["ph"] == "X":
            r.complete(e["ts_us"], e["dur_us"], e["cat"], e["name"],
                       e["args"])
    path = chrome_trace.dump(str(tmp_path / "t.json"), ring=r)
    assert chrome_trace.load_events(path) == j_chrome.load_events(path)
    assert len(chrome_trace.load_events(path)) == len(r.snapshot())


class _Req:
    """A finished request as the exemplar store reads it."""

    def __init__(self, i, tenant, kind, dur_us, throttled, error):
        self.id, self.tenant, self.kind = i, tenant, kind
        self.dur_us, self.throttled, self.error = dur_us, throttled, error

    def to_doc(self) -> dict:
        return {"req": self.id, "kind": self.kind, "tenant": self.tenant,
                "dur_us": self.dur_us, "throttled": self.throttled,
                "error": self.error, "t0_us": float(self.id)}


@pytest.mark.parametrize("seed", [0, 5])
def test_exemplar_retention_matches_reference(seed):
    rng = np.random.default_rng(seed)
    stores = [ExemplarStore(per_tenant=4, window=64),
              JExemplarStore(per_tenant=4, window=64)]
    kept = [[], []]
    for i in range(600):
        tenant = ("a", "b", "c")[int(rng.integers(0, 3))]
        kind = ("gather", "step")[int(rng.integers(0, 2))]
        dur = float(rng.lognormal(6.0, 0.6 if tenant != "c" else 1.5))
        throttled = bool(rng.random() < 0.02)
        error = "EIO" if rng.random() < 0.01 else None
        req = _Req(i, tenant, kind, dur, throttled, error)
        for k, s in enumerate(stores):
            kept[k].append(s.offer(req))
    assert kept[0] == kept[1]
    assert EXEMPLAR_FIELDS == J_EXEMPLAR_FIELDS
    assert stores[0].snapshot() == stores[1].snapshot()
    assert stores[0].stats() == stores[1].stats()
    for t in ("a", "b", "c", None):
        assert stores[0].exemplars(t) == stores[1].exemplars(t)
    assert stores[0].tenant_p99_us("c") == stores[1].tenant_p99_us("c")
    stores[0].clear()
    assert stores[0].stats()["exemplars_offered"] == 0


def test_finished_request_offers_itself_to_the_store():
    from strom_torch.obs import request
    from strom_torch.obs.exemplars import store

    before = store.stats()["exemplars_offered"]
    req = request.Request("gather", "exemplar-t")
    req.mark_error(OSError(5, "injected"))
    req.finish()
    assert store.stats()["exemplars_offered"] == before + 1
    assert store.exemplars("exemplar-t")[-1]["req"] == req.id


SEQ = 16


@pytest.fixture()
def token_shards(tmp_path):
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.formats.rawbin import write_token_shard

    rng = np.random.default_rng(11)
    paths = []
    with StromContext(StromConfig(engine="python")) as ctx:
        for i, n in enumerate((24 * (SEQ + 1), 18 * (SEQ + 1))):
            p = str(tmp_path / f"tok{i}.bin")
            write_token_shard(ctx, p, rng.integers(0, 1000, n,
                                                   dtype=np.int32))
            paths.append(p)
    return paths


def _spans(events) -> dict:
    return {e["name"]: e["cat"] for e in events if e["ph"] == "X"}


def test_loader_run_emits_reference_spans_and_steps(token_shards):
    """The same seeded llama loader in both packages, 8 steps with a short
    compute sleep each: the port's spans are named and categorised as the
    JAX package's, and the context's steps section has every bucket."""
    import jax
    from jax.sharding import SingleDeviceSharding

    from strom.config import StromConfig as JConfig
    from strom.delivery.core import StromContext as JContext
    from strom.obs.events import ring as j_ring
    from strom.pipelines.llama_pretrain import \
        make_llama_pipeline as j_make_llama_pipeline
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.pipelines.llama_pretrain import make_llama_pipeline

    kw = dict(batch=4, seq_len=SEQ, seed=3, prefetch_depth=1)
    cfg = dict(engine="python", queue_depth=4, num_buffers=4)
    ring.clear()
    ctx = StromContext(StromConfig(**cfg))
    try:
        with make_llama_pipeline(ctx, token_shards, device="cpu", **kw) as p:
            for _ in range(8):
                next(p)
                time.sleep(0.005)
        port = _spans(ring.snapshot())
        steps = ctx.stats()["steps"]
    finally:
        ctx.close()
    j_ring.clear()
    jctx = JContext(JConfig(**cfg))
    try:
        with j_make_llama_pipeline(
                jctx, token_shards,
                sharding=SingleDeviceSharding(jax.devices()[0]), **kw) as jp:
            for _ in range(8):
                next(jp)
                time.sleep(0.005)
        ref = _spans(j_ring.snapshot())
    finally:
        jctx.close()
    for name in ("pipeline.next", "strom.read_segments", "engine.slice",
                 "sched.grant", "sched.queue",
                 "engine.python.read_vectored"):
        assert name in port, (name, sorted(port))
    assert {n: port[n] for n in port if n in ref} == \
        {n: ref[n] for n in port if n in ref}
    # the reference's steps section: the STALL_FIELDS and the ring's drops
    assert set(steps) == set(stall.STALL_FIELDS) | {"events_dropped"}
    assert steps["steps_observed"] >= 6
    assert 0.0 < steps["goodput_pct"] <= 100.0
    assert steps["step_compute_p50_us"] > 0


def test_steps_section_is_cached_and_publishes_bucket_growth(monkeypatch):
    from strom_torch.config import StromConfig
    from strom_torch.delivery import core
    from strom_torch.delivery.core import StromContext
    from strom_torch.utils.stats import global_stats

    ctx = StromContext(StromConfig(engine="python"))
    try:
        t0 = ring.now_us()
        for i in range(4):
            ring.complete(t0 + i * 1000.0, 300.0, "ingest_wait",
                          "pipeline.next", None)
            ring.complete(t0 + i * 1000.0 + 50.0, 100.0, "read", "r", None)
        before = global_stats.counter("stall_read_us").value
        first = ctx.stats()["steps"]
        assert first["steps_observed"] >= 3
        grew = global_stats.counter("stall_read_us").value - before
        assert grew > 0
        ring.complete(t0 + 4000.0, 300.0, "ingest_wait", "pipeline.next",
                      None)
        assert ctx.stats()["steps"] == first     # inside the 2 s TTL
        monkeypatch.setattr(core, "_STEPS_TTL_S", 0.0)
        assert ctx.stats()["steps"]["steps_observed"] \
            == first["steps_observed"] + 1
        assert ctx._current_goodput() == ctx.stats()["steps"]["goodput_pct"]
    finally:
        ctx.close()


def test_chrome_round_trip_of_a_context_run(token_shards, tmp_path):
    """A loader run's ring dumps to a Perfetto file and loads back whole."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.pipelines.llama_pretrain import make_llama_pipeline

    ring.clear()
    with StromContext(StromConfig(engine="python")) as ctx, \
            make_llama_pipeline(ctx, token_shards, device="cpu", batch=4,
                                seq_len=SEQ, seed=1) as p:
        for _ in range(4):
            next(p)
    n = len(ring.snapshot())
    path = chrome_trace.dump(str(tmp_path / "run.json"))
    evs = chrome_trace.load_events(path)
    assert len(evs) == n > 0
    with open(path) as f:
        doc = json.load(f)
    assert {e["ph"] for e in doc["traceEvents"]} >= {"X"}
