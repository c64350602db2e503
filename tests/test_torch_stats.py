"""The port's stats registry against the JAX package's: the same seeded
sequence of counter adds, gauge sets and histogram observations, written
through the registry itself and through label scopes of it, gives equal
``snapshot()`` and ``scopes_snapshot()`` in both packages."""

import numpy as np
import pytest

from strom.utils import stats as ref_stats
from strom_torch.utils import stats as port_stats

NAMES = ["ops", "bytes", "hits", "sched_granted_bytes"]
GAUGES = ["depth", "inflight"]
HISTS = ["engine_op_lat", "sched_queue_wait"]
LABELS = [{}, {"tenant": "llama"}, {"tenant": "vis0", "pipeline": "resnet"},
          {"tenant": "pq"}, {"pipeline": "parquet", "tenant": "pq"}]


def _script(seed: int, n: int = 400) -> list[tuple]:
    """A seeded list of (labels index, kind, name, value) writes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        li = int(rng.integers(len(LABELS)))
        kind = ["add", "gauge", "max", "hist", "timer_free"][
            int(rng.integers(5))]
        if kind == "add":
            out.append((li, kind, NAMES[int(rng.integers(len(NAMES)))],
                        int(rng.integers(1, 1 << 20))))
        elif kind in ("gauge", "max"):
            out.append((li, kind, GAUGES[int(rng.integers(len(GAUGES)))],
                        int(rng.integers(0, 1000))))
        else:
            # log-uniform latencies, 0.3 us to ~30 s, across every bucket
            us = float(10 ** rng.uniform(-0.5, 7.5))
            out.append((li, "hist", HISTS[int(rng.integers(len(HISTS)))],
                        us))
    return out


def _run(mod, script):
    reg = mod.StatsRegistry("strom")
    for li, kind, name, v in script:
        sc = reg.scoped(**LABELS[li])
        if kind == "add":
            sc.add(name, v)
        elif kind == "gauge":
            sc.set_gauge(name, v)
        elif kind == "max":
            sc.gauge(name).max(v)
        else:
            sc.observe_us(name, v)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snapshots_equal_reference(seed):
    script = _script(seed)
    ref = _run(ref_stats, script)
    port = _run(port_stats, script)
    assert port.snapshot() == ref.snapshot()
    assert port.scopes_snapshot() == ref.scopes_snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_is_the_sum_of_its_scopes(seed):
    """Every scoped add lands in the aggregate too (counters and
    histogram counts), as the reference promises."""
    reg = _run(port_stats, _script(seed))
    agg = reg.snapshot()
    scopes = reg.scopes_snapshot()
    unscoped = _run(port_stats, [w for w in _script(seed) if w[0] == 0])
    for name in NAMES:
        total = unscoped.snapshot().get(name, 0) + sum(
            s.get(name, 0) for s in scopes.values())
        assert agg.get(name, 0) == total
    for name in HISTS:
        total = unscoped.snapshot().get(name + "_count", 0) + sum(
            s.get(name + "_count", 0) for s in scopes.values())
        assert agg.get(name + "_count", 0) == total


def test_scope_identity_and_refinement_match_reference():
    for mod in (ref_stats, port_stats):
        reg = mod.StatsRegistry("x")
        assert reg.scoped() is reg
        assert reg.scoped(tenant=None) is reg
        a = reg.scoped(tenant="t0")
        b = a.scoped(pipeline="p")
        assert b.labels == {"tenant": "t0", "pipeline": "p"}
        a.add("n", 3)
        reg.scoped(tenant="t0").add("n", 4)   # same labels, same series
        assert a.counter("n").value == 7
    assert port_stats.format_labels({"b": 'q"\n', "a": "x\\y"}) == \
        ref_stats.format_labels({"b": 'q"\n', "a": "x\\y"})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_from_buckets_matches_reference(seed):
    rng = np.random.default_rng(seed)
    buckets = [int(x) for x in rng.integers(0, 50, 24)]
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert port_stats.percentile_from_buckets(buckets, q) == \
            ref_stats.percentile_from_buckets(buckets, q)
    assert port_stats.percentile_from_buckets([0] * 24, 0.5) == 0.0


def test_bulk_bucket_merge_matches_reference():
    deltas = [3, 0, 1, 7] + [0] * 20
    regs = []
    for mod in (ref_stats, port_stats):
        reg = mod.StatsRegistry("x")
        reg.scoped(tenant="t").histogram("engine_op_lat").add_buckets(
            deltas, 123.5)
        reg.observe_us("engine_op_lat", 5.0)
        regs.append(reg)
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].scopes_snapshot() == regs[0].scopes_snapshot()


def test_global_stats_is_process_wide():
    from strom_torch.utils.stats import global_stats

    assert isinstance(global_stats, port_stats.StatsRegistry)
    assert global_stats.name == "strom"
    assert global_stats.scoped(tenant="x").parent is global_stats
