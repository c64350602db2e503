"""The port's nested ``stats(sections=)`` held to the JAX package's: the same
section names (``dist`` too, on contexts that serve and ask peers), the
same keys in each (less the port's documented names:
``ssd2gpu_bytes`` for the reference's ``ssd2tpu_bytes``, its own
``transfers``/``streamed_transfers``/``stream_gathers`` counters, and the
engine's and slab pool's keys that differ since those layers were ported),
and the same growth of every context and stream counter over one seeded
gather; ``sections=`` computes only what it names, so a counters-only
scrape never recomputes the stall attribution; and the ``engine_inflight``
gauge per op scope reads above 0 mid-gather and 0 after it in both
packages."""

import json
import threading
import time

import numpy as np
import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.delivery.extents import Extent as JExtent
from strom.delivery.extents import ExtentList as JExtentList
from strom.utils.stats import global_stats as j_stats
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.extents import Extent, ExtentList
from strom_torch.delivery.shard import Segment
from strom_torch.obs import stall
from strom_torch.utils.stats import global_stats as t_stats

MiB = 1 << 20
RENAMED = {"ssd2tpu_bytes": "ssd2gpu_bytes"}
PORT_ONLY = {"context": {"transfers", "streamed_transfers"},
             "stream": {"stream_gathers"}}
# keys of the layers ported before the sections were (each side's own
# counters); pinned here so that any new drift fails
ENGINE_DIFF = ({"engine_fixed_buf_ratio", "engine_unregistered_reads",
                "enter_submit_calls", "ops_fixed", "read_latency_count",
                "read_latency_hist", "read_latency_mean_us",
                "read_latency_p50_us", "read_latency_p99_us",
                "read_latency_total_us", "sqpoll_wakeups"},
               {"buffered_writes", "bytes_written", "direct_writes",
                "media_bytes", "o_direct_denied", "ops_errored",
                "ops_faulted", "ops_written", "unaligned_fallback_reads",
                "unaligned_fallback_writes"})
SLAB_DIFF = ({"buckets", "huge", "mlock_cap_bytes", "mlocked_bytes"},
             {"parked_bytes", "pinned_bytes", "registered_slabs"})


def _cfg(Cfg, **kw):
    return Cfg(engine="python", queue_depth=8, num_buffers=8,
               hot_cache_bytes=8 * MiB, hot_cache_admit="always",
               **kw)


@pytest.fixture()
def pair():
    t, j = StromContext(_cfg(StromConfig)), JContext(_cfg(JConfig))
    yield t, j
    t.close()
    j.close()


def _numeric(sec: dict) -> dict:
    return {k: v for k, v in sec.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def test_same_sections_and_keys(pair, data_file):
    path, _ = data_file
    t, j = pair
    t.pread(path, 0, MiB)
    j.pread(path, 0, MiB)
    # then each serves its peers and asks the other's server: the dist
    # section (the peer tier's keys and the server's) is in both
    t.attach_peers({0: j.serve_peers()}, owner_fn=lambda p: 0)
    j.attach_peers({0: t.serve_peers()}, owner_fn=lambda p: 0)
    t.pread(path, MiB, MiB)
    j.pread(path, MiB, MiB)
    ts, js = t.stats(), j.stats()
    assert set(ts) == set(js)
    assert set(ts) >= {"context", "decode", "stream", "steps", "cache",
                       "slab_pool", "engine", "sched", "slo", "exemplars",
                       "resilience", "scopes", "dist"}
    for sec in ts:
        if sec == "scopes":
            continue
        want = {RENAMED.get(k, k) for k in js[sec]}
        got = set(ts[sec])
        if sec == "engine":
            assert (want - got, got - want) == ENGINE_DIFF
        elif sec == "slab_pool":
            assert (want - got, got - want) == SLAB_DIFF
        else:
            assert got - PORT_ONLY.get(sec, set()) == want, sec
    # no flat key is left at the top level
    assert all(isinstance(v, dict) for v in ts.values())


def test_seeded_gather_moves_the_same_counters(pair, data_file):
    path, golden = data_file
    t, j = pair
    rng = np.random.default_rng(7)
    spans = [(int(o), int(n)) for o, n in zip(
        rng.integers(0, 3 * MiB, 12), rng.integers(1, 64 * 1024, 12))]
    spans += [(4 * MiB - 8192, 4096), (4 * MiB - 4096, 4096)]  # adjacent
    secs = ("context", "stream")
    t0, j0 = t.stats(secs), j.stats(secs)
    got = t.pread(ExtentList([Extent(path, o, n) for o, n in spans]))
    want = j.pread(JExtentList([JExtent(path, o, n) for o, n in spans]))
    assert bytes(got) == bytes(memoryview(want))
    dest = t.alloc_read_buffer(ExtentList([Extent(path, 0, MiB)]), MiB)
    g = t.stream_segments(path, [Segment(0, 0, MiB)], dest)
    while not g.done:
        g.poll(min_completions=1, timeout_s=0.5)
    g.finish()
    g.close()
    t1, j1 = t.stats(secs), j.stats(secs)
    for sec in secs:
        td = {k: v - t0[sec][k] for k, v in _numeric(t1[sec]).items()
              if not k.endswith(("_hist", "_last"))}
        jd = {RENAMED.get(k, k): v - j0[sec][k]
              for k, v in _numeric(j1[sec]).items()
              if not k.endswith(("_hist", "_last"))}
        if sec == "context":
            assert td["ssd2gpu_bytes"] - jd["ssd2gpu_bytes"] == MiB
            td["ssd2gpu_bytes"] -= MiB       # the port's streamed gather
            assert {k: td[k] for k in jd} == jd
            assert jd["coalesce_ops_in"] > jd["coalesce_ops_out"] > 0
            assert jd["registered_files"] == 1
            assert t1[sec]["coalesce_ops_out_last"] \
                == j1[sec]["coalesce_ops_out_last"]
        else:
            assert td["stream_gathers"] == 1
            assert td["stream_tail_extent_count"] == 1
            assert t1[sec]["stream_inflight_peak"] >= 1


def test_sections_compute_only_what_they_name(pair, monkeypatch):
    t, _ = pair
    calls = []
    real = stall.steps_summary
    monkeypatch.setattr(stall, "steps_summary",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert set(t.stats(["context", "sched"])) == {"context", "sched"}
    assert set(t.stats(("engine", "bogus"))) == {"engine"}
    assert calls == []
    steps = t.stats(["steps"])["steps"]
    assert calls == [1] and "events_dropped" in steps
    assert t.stats(["steps"])["steps"] == steps     # inside the TTL
    assert calls == [1]
    assert set(t.stats([])) == set()


def _inflight_mid_gather(Ctx, Cfg, reg, path) -> tuple[int, int]:
    """The engine_inflight gauge's largest reading while a gather runs
    with its first op held 0.3 s, and its value after."""
    hold = json.dumps({"seed": 0, "rules": [
        {"kind": "latency", "op": "read", "op_lo": 0, "op_hi": 1,
         "latency_s": 0.3}]})
    ctx = Ctx(Cfg(engine="python", queue_depth=8, num_buffers=8,
                  fault_plan=hold, hedge_enabled=False))
    seen = []
    done = threading.Event()

    def watch():
        while not done.is_set():
            seen.append(reg.gauge("engine_inflight").value)
            time.sleep(0.002)

    w = threading.Thread(target=watch)
    try:
        w.start()
        ctx.pread(path, 0, 2 * MiB)
    finally:
        done.set()
        w.join()
        ctx.close()
    return max(seen), reg.gauge("engine_inflight").value


def test_engine_inflight_mid_gather_and_after(data_file):
    path, _ = data_file
    got = {k: _inflight_mid_gather(Ctx, Cfg, reg, path)
           for k, Ctx, Cfg, reg in (
               ("torch", StromContext, StromConfig, t_stats),
               ("jax", JContext, JConfig, j_stats))}
    for k, (peak, after) in got.items():
        assert peak > 0 and after == 0, (k, peak, after)
