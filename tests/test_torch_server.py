"""The port's metrics server held to the JAX package's: both servers over
one fake ``stats_fn`` answer every route with the same status code and the
same JSON keys (404 for /slo, /tune, /history, /tenants and /cluster when
the context has none; 400 on a malformed filter), and the same section
text on /metrics; with an SLO engine, a history, a tuner and a cluster view
of each package attached, /slo, /history, /tune and /cluster carry equal
bodies. A live ``StromContext(metrics_port=0)`` serves /tenants (GET and
POST), /trace filters, /metrics?sections=, and a failed bind leaves no
sampler or watchdog thread behind."""

import json
import socket
import threading
import urllib.error
import urllib.request

import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.obs import federation as jfed
from strom.obs import history as jhist
from strom.obs import server as jserver
from strom.obs import slo as jslo
from strom import tune as jtune
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.obs import federation as tfed
from strom_torch.obs import history as thist
from strom_torch.obs import server as tserver
from strom_torch.obs import slo as tslo
from strom_torch import tune as ttune

MODS = {"jax": (jserver, jslo, jhist, jtune, jfed),
        "torch": (tserver, tslo, thist, ttune, tfed)}


def _get(port: int, route: str, body: "bytes | None" = None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=body)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _fake_stats(sections=None):
    secs = {"probe_sec": {"probe_bytes": 12, "probe_depth": 3,
                          "probe_lat_hist": [1, 0, 2],
                          "probe_lat_total_us": 7.5,
                          "probe_lat_p50_us": 4.0,
                          "probe_lat_count": 3},
            "probe_two": {"probe_ok": True, "probe_name": "x"},
            "scopes": {'tenant="a"': {"probe_bytes": 1}}}
    if sections is None:
        return secs
    return {k: v for k, v in secs.items() if k in sections}


class _Ctx:
    """A context-shaped object: every optional part absent."""

    slo = history = tuner = cluster_view = scheduler = None

    def stats(self, sections=None):
        return _fake_stats(sections)


ROUTES = ("/metrics", "/metrics?sections=probe_sec", "/stats",
          "/stats?sections=probe_two", "/trace", "/trace?cat=sched,read",
          "/trace?since_us=0", "/trace?since_us=abc", "/slo", "/tune",
          "/history", "/history?since_s=x", "/tenants", "/cluster",
          "/flight", "/nope")


def _serve_all(ctxs: dict) -> dict:
    out = {}
    for k, ctx in ctxs.items():
        srv = MODS[k][0].MetricsServer(_fake_stats, port=0, ctx=ctx)
        try:
            out[k] = {r: _get(srv.port, r) for r in ROUTES}
        finally:
            srv.close()
    return out


def _keys(body: bytes):
    doc = json.loads(body)
    return sorted(doc) if isinstance(doc, dict) else type(doc).__name__


def test_routes_without_parts_match():
    got = _serve_all({"jax": _Ctx(), "torch": _Ctx()})
    codes = {k: {r: v[0] for r, v in got[k].items()} for k in got}
    assert codes["torch"] == codes["jax"]
    assert codes["torch"]["/trace?since_us=abc"] == 400
    assert codes["torch"]["/history?since_s=x"] == 404   # no history
    for r in ("/slo", "/tune", "/history", "/tenants", "/cluster", "/nope"):
        assert codes["torch"][r] == 404, r
    for r in ("/stats", "/stats?sections=probe_two", "/trace", "/flight"):
        assert _keys(got["torch"][r][1]) == _keys(got["jax"][r][1]), r
    st = json.loads(got["torch"]["/stats?sections=probe_two"][1])
    assert list(st["sections"]) == ["probe_two"]

    def section_lines(text: bytes) -> list:
        return [ln for ln in text.decode().splitlines()
                if "probe_" in ln]

    for r in ("/metrics", "/metrics?sections=probe_sec"):
        assert section_lines(got["torch"][r][1]) == \
            section_lines(got["jax"][r][1]), r
    assert "strom_probe_sec_probe_lat_us_count 3" in \
        got["torch"]["/metrics?sections=probe_sec"][1].decode()
    assert "probe_two" not in \
        got["torch"]["/metrics?sections=probe_sec"][1].decode()


class _Clock:
    def __init__(self) -> None:
        self.t = 10.0

    def __call__(self) -> float:
        return self.t


def _parts(k: str):
    """An SLO engine, a history, a tuner and a cluster view of package
    *k*, each fed the same state."""
    _, slo, hist, tune, fed = MODS[k]
    clock = _Clock()
    eng = slo.SloEngine(clock=clock)
    eng.set_target("srv_tight", gather_p99_us=10.0)
    for i in range(20):
        eng.observe("srv_tight", 50.0 + i)
        eng.observe("srv_loose", 5.0)
    h = hist.StatsHistory(clock=clock, start=False)
    for _ in range(3):
        h.sample()
        clock.t += 2.0
    x = [3.0]
    knob = tune.Knob("x", get=lambda: x[0],
                     set=lambda v: x.__setitem__(0, v),
                     lo=0.0, hi=9.0, step=1.0)
    tuner = tune.Autotuner([knob], lambda: {"objective": 10.0 - x[0]},
                           clock=clock)
    for _ in range(4):
        tuner.step()
    snaps = {"h0": {"global": {"ssd2gpu_bytes": 5, "lat_hist": [1, 2],
                               "lat_total_us": 4.0}},
             "h1": {"global": {"ssd2gpu_bytes": 7, "lat_hist": [0, 3],
                               "lat_total_us": 9.0}}}
    # polled once here and read seconds later: every route served before
    # /cluster (the /trace ones serialise the process-wide event ring, full
    # after earlier tests) can take longer than the default stale_s (5 s)
    # under load, and aged-out hosts would empty the aggregate
    view = fed.ClusterView({"h0": "a:1", "h1": "b:2"},
                           fetch_fn=lambda a: snaps["h0" if a == "a:1"
                                                    else "h1"],
                           flight_fn=lambda a: None, start=False,
                           publish=False, stale_s=3600.0)
    view.poll_now()

    class Ctx(_Ctx):
        pass

    c = Ctx()
    c.slo, c.history, c.tuner, c.cluster_view = eng, h, tuner, view
    return c


def test_routes_with_parts_match():
    got = _serve_all({k: _parts(k) for k in MODS})
    for r in ("/slo", "/tune", "/history", "/cluster"):
        assert got["torch"][r][0] == got["jax"][r][0] == 200, r
    assert json.loads(got["torch"]["/slo"][1]) == \
        json.loads(got["jax"]["/slo"][1])
    assert json.loads(got["torch"]["/tune"][1]) == \
        json.loads(got["jax"]["/tune"][1])
    th = json.loads(got["torch"]["/history"][1])
    jh = json.loads(got["jax"]["/history"][1])
    assert {k: v for k, v in th.items() if k != "samples"} == \
        {k: v for k, v in jh.items() if k != "samples"}
    assert [s["ts_s"] for s in th["samples"]] == \
        [s["ts_s"] for s in jh["samples"]]
    tc = json.loads(got["torch"]["/cluster"][1])
    jc = json.loads(got["jax"]["/cluster"][1])
    assert tc["aggregate"] == jc["aggregate"]
    assert tc["aggregate"]["ssd2gpu_bytes"] == 12
    assert {h: sorted(r) for h, r in tc["hosts"].items()} == \
        {h: sorted(r) for h, r in jc["hosts"].items()}
    assert got["torch"]["/history?since_s=x"][0] == 400
    assert json.loads(got["torch"]["/slo"][1])["tenants"]["srv_tight"][
        "slo_burning"]


def _cfg(Cfg, **kw):
    return Cfg(engine="python", queue_depth=8, num_buffers=8, **kw)


def test_live_context_routes_match(data_file):
    path, _ = data_file
    got = {}
    for k, Ctx, Cfg in (("torch", StromContext, StromConfig),
                        ("jax", JContext, JConfig)):
        ctx = Ctx(_cfg(Cfg, history_interval_s=0.05), metrics_port=0)
        try:
            port = ctx.metrics_server.port
            ctx.pread(path, 0, 1 << 20)
            res = {r: _get(port, r) for r in ROUTES}
            res["POST register"] = _get(port, "/tenants", json.dumps(
                {"op": "register", "name": "posted", "priority":
                 "interactive", "weight": 2}).encode())
            res["POST drain"] = _get(port, "/tenants", json.dumps(
                {"op": "drain", "name": "posted"}).encode())
            res["POST bad op"] = _get(port, "/tenants", b'{"op": "x"}')
            res["POST bad body"] = _get(port, "/tenants", b"[1,")
            res["POST bad field"] = _get(port, "/tenants", json.dumps(
                {"op": "register", "name": "w", "weight": "abc"}).encode())
            res["tenants after"] = _get(port, "/tenants")
            got[k] = res
        finally:
            ctx.close()
    codes = {k: {r: v[0] for r, v in got[k].items()} for k in got}
    assert codes["torch"] == codes["jax"]
    t, j = got["torch"], got["jax"]
    assert codes["torch"]["/tenants"] == codes["torch"]["/slo"] == 200
    assert codes["torch"]["/history"] == 200
    assert codes["torch"]["/tune"] == codes["torch"]["/cluster"] == 404
    assert [codes["torch"][f"POST {w}"] for w in
            ("register", "drain", "bad op", "bad body", "bad field")] == \
        [200, 200, 400, 400, 400]
    assert _keys(t["/tenants"][1]) == _keys(j["/tenants"][1])
    rows = json.loads(t["tenants after"][1])["tenants"]
    assert rows["posted"]["priority"] == "interactive"
    assert sorted(rows["posted"]) == sorted(
        json.loads(j["tenants after"][1])["tenants"]["posted"])
    assert json.loads(t["POST drain"][1]) == json.loads(j["POST drain"][1])
    # cat= keeps only the named categories
    cats = {e.get("cat") for e in
            json.loads(t["/trace?cat=sched,read"][1])["traceEvents"]
            if e.get("ph") != "M"}
    assert cats <= {"sched", "read"}
    # the section sweep names only what was asked (and the registry)
    only = t["/metrics?sections=probe_sec"][1].decode()
    assert "strom_context_" not in only and "strom_ssd2gpu_bytes" in only
    full = t["/metrics"][1].decode()
    assert "strom_context_ssd2gpu_bytes" in full
    assert "strom_engine_" in full and "strom_slo_slo_tenants" in full


def test_failed_bind_leaves_no_thread(tmp_path):
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    port = busy.getsockname()[1]
    before = {t.ident for t in threading.enumerate()}
    try:
        with pytest.raises(OSError):
            StromContext(_cfg(StromConfig, history_interval_s=0.05,
                              flight_dir=str(tmp_path / "fl")),
                         metrics_port=port)
    finally:
        busy.close()
    left = [t.name for t in threading.enumerate()
            if t.ident not in before and t.is_alive()
            and t.name in ("strom-history", "strom-flight")]
    assert left == []


def test_metrics_port_from_the_config():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    with StromContext(_cfg(StromConfig, metrics_port=port)) as ctx:
        assert ctx.metrics_server.port == port
        assert _get(port, "/stats?sections=context")[0] == 200
