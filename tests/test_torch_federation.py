"""The port's metrics federation held to the JAX package's: ``merge_snapshots``
of the same seeded per-host snapshots is equal in both packages, every
aggregate series is the sum of the hosts' (bucket lists element-wise), and
each percentile is derived again from the merged buckets, never averaged;
a ``ClusterView`` on a fake clock flips a host unhealthy when its scrape
fails past ``stale_s`` or its progress stalls past ``stall_s``, asks it for
a flight dump once and dumps the coordinator's recorder, in both packages
alike. The registries are process-wide, so hosts are ``fetch_fn`` fakes or
a subprocess with its own registry."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from strom.obs import federation as jfed
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.obs import federation as tfed
from strom_torch.utils.stats import percentile_from_buckets

PKGS = {"jax": jfed, "torch": tfed}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snaps(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for h in range(3 + seed % 2):
        snap = {"ssd2gpu_bytes": int(rng.integers(0, 1 << 30)),
                "engine_inflight": int(rng.integers(0, 32)),
                "ratio": float(rng.random()),
                "flag": bool(rng.integers(0, 2)),
                "engine": "python"}
        if h != 1:                       # a host missing a series
            snap["only_some"] = int(rng.integers(0, 100))
        buckets = [int(v) for v in rng.integers(0, 50, 24)]
        total = float(rng.uniform(1e3, 1e6))
        snap.update({"lat_hist": buckets, "lat_total_us": total,
                     "lat_count": sum(buckets), "lat_mean_us": 1.0,
                     "lat_p50_us": 2.0, "lat_p99_us": 3.0})
        out[f"h{h}"] = snap
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_matches_and_aggregate_is_the_sum(seed):
    snaps = _snaps(seed)
    agg = tfed.merge_snapshots(snaps)
    assert agg == jfed.merge_snapshots(snaps)
    for k in ("ssd2gpu_bytes", "engine_inflight", "only_some"):
        assert agg[k] == sum(s.get(k, 0) for s in snaps.values()), k
    assert agg["ratio"] == pytest.approx(sum(s["ratio"]
                                             for s in snaps.values()))
    assert agg["flag"] == sum(int(s["flag"]) for s in snaps.values())
    assert "engine" not in agg
    merged = [sum(s["lat_hist"][i] for s in snaps.values())
              for i in range(24)]
    assert agg["lat_hist"] == merged
    assert agg["lat_count"] == sum(merged)
    assert agg["lat_total_us"] == pytest.approx(
        sum(s["lat_total_us"] for s in snaps.values()))
    # derived again from the merged buckets: not a sum or mean of p99s
    assert agg["lat_p99_us"] == percentile_from_buckets(merged, 0.99)
    assert agg["lat_p50_us"] == percentile_from_buckets(merged, 0.50)
    assert tfed.FED_FIELDS == jfed.FED_FIELDS


class FakeTime:
    def __init__(self) -> None:
        self.t = 100.0

    def monotonic(self) -> float:
        return self.t

    def perf_counter(self) -> float:
        return self.t


class Recorder:
    def __init__(self) -> None:
        self.dumps = []

    def dump(self, reason: str, note: str = "") -> str:
        self.dumps.append((reason, note))
        return "bundle"


def _watch(mod, monkeypatch):
    """A view over two fake hosts on a fake clock; h0's scrape can be made
    to fail and h1's progress to stop."""
    clock = FakeTime()
    monkeypatch.setattr(mod, "time", clock)
    state = {"h0_up": True, "h1_bytes": 0}
    flights = []

    def fetch(addr):
        if addr == "a:1":
            if not state["h0_up"]:
                raise ConnectionError("down")
            return {"global": {"ssd2gpu_bytes": clock.t}, "sections": {}}
        return {"global": {"ssd2gpu_bytes": state["h1_bytes"]},
                "sections": {"steps": {"goodput_pct": 80.0}}}

    rec = Recorder()
    view = mod.ClusterView({"h0": "a:1", "h1": "b:2"}, fetch_fn=fetch,
                           flight_fn=flights.append, recorder=rec,
                           interval_s=1.0, stale_s=3.0, stall_s=5.0,
                           progress_keys=("ssd2gpu_bytes",),
                           publish=False, start=False)
    return view, clock, state, flights, rec


def _script(view, clock, state):
    """Beats of one second; h0 dies at 4 and comes back at 12; h1 stops
    progressing at 6. Returns (healthy flags, fields, aggregate) per
    beat."""
    out = []
    for beat in range(16):
        state["h0_up"] = not 4 <= beat < 12
        if beat < 6:
            state["h1_bytes"] += 1
        view.poll_now()
        snap = view.snapshot()
        out.append(({h: r["healthy"] for h, r in snap["hosts"].items()},
                    {k: v for k, v in view.stats().items()
                     if k != "cluster_scrape_lag_p99_us"},
                    sorted(snap["aggregate"].items())))
        clock.t += 1.0
    return out


def test_progress_defaults_to_the_ports_delivered_bytes():
    """The port's default progress key is its own name for the delivered
    bytes (the reference's ``ssd2tpu_bytes``)."""
    view = tfed.ClusterView({}, fetch_fn=lambda a: {}, start=False,
                            publish=False)
    assert view._progress_keys == ("ssd2gpu_bytes", "peer_serves")


def test_cluster_view_health_matches(monkeypatch):
    runs = {k: _watch(mod, monkeypatch) for k, mod in PKGS.items()}
    got = {k: _script(v, c, s) for k, (v, c, s, _, _) in runs.items()}
    assert got["torch"] == got["jax"]
    h0 = [flags["h0"] for flags, _, _ in got["torch"]]
    h1 = [flags["h1"] for flags, _, _ in got["torch"]]
    # h0: its last good scrape ages past stale_s (3 s), then it recovers
    assert h0[:7] == [True] * 7 and not any(h0[8:12]) and h0[12]
    # h1: no progress for more than stall_s (5 s) after beat 5
    assert h1[:11] == [True] * 11 and not any(h1[11:])
    for k, (_, _, _, flights, rec) in runs.items():
        assert flights == ["a:1", "b:2"], k
        assert rec.dumps == [("cluster_unhealthy", "host=h0"),
                             ("cluster_unhealthy", "host=h1")], k
    # a stale host stops contributing to the aggregate
    assert dict(got["torch"][9][2]).get("ssd2gpu_bytes") == 6


_HOST = (
    "import sys\n"
    "from strom_torch.config import StromConfig\n"
    "from strom_torch.delivery.core import StromContext\n"
    "ctx = StromContext(StromConfig(engine='python'), metrics_port=0)\n"
    "ctx.pread(sys.argv[1], 0, 1 << 20)\n"
    "print(ctx.metrics_server.port, flush=True)\n"
    "sys.stdin.read()\n")


def test_two_processes_federate_and_a_killed_one_flips(data_file,
                                                        tmp_path):
    """One host is a subprocess (a registry of its own), the other this
    process's context; the aggregate is the sum of the two global
    snapshots; killing the subprocess flips it unhealthy and leaves a
    flight bundle of the coordinator."""
    path, _ = data_file
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen([sys.executable, "-c", _HOST, path], cwd=ROOT,
                            env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline())
        cfg = StromConfig(engine="python", flight_dir=str(tmp_path / "fl"),
                          flight_stall_s=0.0)
        with StromContext(cfg, metrics_port=0) as ctx:
            ctx.pread(path, 0, 1 << 20)
            me = ctx.metrics_server.port
            # no background loop: its first poll would scrape this
            # process's endpoint beside the test's own (the reference's
            # test builds its view the same way); stale_s above the 2 s
            # scrape timeout, so a slow scrape that succeeds cannot age a
            # host out before snapshot() reads it
            view = ctx.attach_cluster(
                {"sub": f"127.0.0.1:{port}", "me": f"127.0.0.1:{me}"},
                interval_s=60.0, stale_s=5.0, stall_s=600.0, start=False)
            view.poll_now()
            snap = view.snapshot()
            assert all(r["healthy"] for r in snap["hosts"].values())
            fetched = {h: tfed._http_fetch(a, ("steps",))["global"]
                       for h, a in (("sub", f"127.0.0.1:{port}"),
                                    ("me", f"127.0.0.1:{me}"))}
            assert fetched["sub"]["ssd2gpu_bytes"] >= 1 << 20
            # the aggregate of two hosts is the sum of their counters
            # (this process's moved only by what the scrapes did not touch)
            assert snap["aggregate"]["ssd2gpu_bytes"] == sum(
                f["ssd2gpu_bytes"] for f in fetched.values())
            proc.kill()
            proc.wait(timeout=30)
            deadline = time.monotonic() + 30.0
            while view.snapshot()["hosts"]["sub"]["healthy"]:
                assert time.monotonic() < deadline, "never flipped"
                time.sleep(0.2)
                view.poll_now()
            assert view.stats()["cluster_hosts_unhealthy"] == 1
            assert _get_json(me, "/cluster")["cluster_hosts_unhealthy"] == 1
        bundles = os.listdir(tmp_path / "fl")
        assert any("cluster_unhealthy" in b for b in bundles), bundles
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _get_json(port: int, route: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as r:
        return json.loads(r.read())


def test_steps_section_builds_only_the_contexts_events(tmp_path,
                                                       monkeypatch):
    """A scrape's ``steps`` section summarises the ring's events of the
    context's lifetime and builds no dict for older ones: a full ring
    (65,536 events) of another workload made each scrape of this process's
    endpoint cost ~0.5 s of CPU, which under load ran past the 2 s scrape
    timeout. The summary is the one over the whole ring."""
    from strom_torch.obs import stall
    from strom_torch.obs.events import ring

    for i in range(ring.capacity + 8):
        with ring.span("old", cat="engine", args={"i": i}):
            pass
    seen = []
    real = stall.steps_summary
    monkeypatch.setattr(stall, "steps_summary",
                        lambda evs, **kw: seen.append(len(evs))
                        or real(evs, **kw))
    with StromContext(StromConfig(engine="python")) as ctx:
        lo = ctx._obs_t0_us
        for i in range(3):
            with ring.span("train.step", cat="step", args={"step": i}):
                with ring.span("pipeline.next", cat="pipeline"):
                    time.sleep(0.001)
        got = ctx.stats(sections=["steps"])["steps"]
        whole = stall.flatten_summary(real(ring.snapshot(), lo_us=lo))
    assert seen and seen[0] < 64, seen
    assert {k: got[k] for k in whole} == whole
    assert got["steps_observed"] == 3


def test_snapshot_since_keeps_what_ends_after_it():
    """``EventRing.snapshot(since_us=)`` is the full snapshot less the
    events that end before *since_us* (spans by their end, instants by
    their time)."""
    from strom_torch.obs.events import EventRing

    r = EventRing(capacity=64)
    with r.span("a", cat="x"):
        time.sleep(0.002)
        mid = r.now_us()
        r.instant("before", cat="x")
        time.sleep(0.002)
    r.instant("after", cat="x")
    full = r.snapshot()
    cut = r.snapshot(since_us=mid + 1000)
    assert [e["name"] for e in cut] == [
        e["name"] for e in full
        if e["ts_us"] + e.get("dur_us", 0.0) >= mid + 1000]
    assert {e["name"] for e in r.snapshot(since_us=mid)} == \
        {"a", "before", "after"}
