"""Live observability endpoint: a stdlib HTTP server in the background
(the port's copy of ``strom/obs/server.py``).

The reference's stats can be read while a run is live (``cat
/proc/nvme-strom`` mid-transfer); this server makes the port's in-process
state scrapeable the same way, with ``http.server`` alone:

- ``GET /metrics`` — Prometheus text: the process-wide registry (scopes as
  labelled samples) and, with a ``stats_fn``, the context's sections
  through ``sections_prometheus``. ``?sections=context,sched`` restricts
  the sweep, so a scrape that wants counters never pays for the stall
  attribution; each section's text is cached for ``section_ttl_s``.
- ``GET /stats`` — the same sections as JSON (scopes included); takes
  ``?sections=`` too.
- ``GET /trace`` — the event ring as Trace Event JSON; ``?cat=read,sched``
  and ``?since_us=`` filter server-side. A malformed number is 400.
- ``GET /slo`` — the SLO engine's report; ``GET /tune`` — the autotuner's
  state; ``GET /history`` — the snapshot ring (``?since_s=``, ``?keys=``).
  Each is 404 when the context has none.
- ``GET /tenants`` — the scheduler's ``tenants_info()``; ``POST /tenants``
  registers (``{"op": "register", "name": "t0", ...}``) or drains
  (``{"op": "drain", "name": "t0"}``) a tenant. 404 without a scheduler.
- ``GET /flight`` — an on-demand flight capture (stacks, stats, trace, and
  the recorder's samples when one runs); ``?dump=1`` also writes a bundle.
- ``GET /cluster`` — the federation view (``ClusterView.snapshot()``), 404
  without ``attach_cluster``.

No route makes a CUDA call: every reader is host state, so a scrape beside
a captured step neither synchronises the device nor joins the capture.
Wired as ``StromContext(metrics_port=...)`` / ``StromConfig.metrics_port``;
port 0 passed explicitly asks the OS for an ephemeral port (``.port``
reports it).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from strom_torch.obs.chrome_trace import trace_document
from strom_torch.obs.events import EventRing, ring as _global_ring
from strom_torch.utils.locks import make_lock

# sections that are nested maps (not flat numeric leaves): excluded from
# the Prometheus section sweep — their data reaches /metrics another way
# (scopes render as labels straight from the registry) or is non-numeric
_NON_EXPOSITION_SECTIONS = frozenset({"scopes"})


class _BadQuery(ValueError):
    """Malformed query parameter: the client's fault → 400, not 500."""


class MetricsServer:
    """Background HTTP server over a stats callable and an event ring.

    *stats_fn* returns the nested sections dict (``StromContext.stats``
    shape) or None; it may accept a ``sections=`` keyword (StromContext's
    does) to compute only a subset — the per-section TTL cache uses that
    so refreshing one stale section never recomputes the rest. The global
    stats registry is always included in ``/metrics``. Serving threads are
    daemonic: an abandoned server never blocks process exit, though
    :meth:`close` is the polite path.
    """

    def __init__(self, stats_fn: Callable[[], dict] | None = None, *,
                 port: int = 0, host: str = "127.0.0.1",
                 ring: EventRing | None = None,
                 flight=None, ctx=None, section_ttl_s: float = 2.0):
        self._stats_fn = stats_fn
        self._ring = ring or _global_ring
        self._flight = flight
        self._ctx = ctx
        self._ttl = max(float(section_ttl_s), 0.0)
        # last SloEngine.report() refresh driven by a /metrics scrape
        self._slo_refreshed = float("-inf")
        # per-section rendered exposition cache: name -> (monotonic_t, text)
        self._sec_cache: dict[str, tuple[float, str]] = {}
        self._known_sections: list[str] = []
        self._cache_lock = make_lock("app.server_cache")
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a) -> None:  # no per-scrape stderr spam
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _qfloat(self, q: dict, key: str) -> "float | None":
                """Numeric query param, or None when absent. Junk is the
                client's fault: 400 via _BadQuery, not the generic 500
                (the same contract POST /tenants has for bad fields)."""
                if key not in q:
                    return None
                try:
                    return float(q[key][0])
                except ValueError:
                    raise _BadQuery(
                        f"{key}={q[key][0]!r} is not a number") from None

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path, _, query = self.path.partition("?")
                q = urllib.parse.parse_qs(query)
                try:
                    if path == "/metrics":
                        only = None
                        if "sections" in q:
                            only = [s for part in q["sections"]
                                    for s in part.split(",") if s]
                        self._send(200, server._metrics(only).encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/stats":
                        only = None
                        if "sections" in q:
                            only = [s for part in q["sections"]
                                    for s in part.split(",") if s]
                        self._send(200,
                                   json.dumps(server._stats(only)).encode(),
                                   "application/json")
                    elif path == "/trace":
                        events = server._ring.snapshot()
                        if "cat" in q:
                            cats = {c for part in q["cat"]
                                    for c in part.split(",") if c}
                            events = [e for e in events
                                      if e.get("cat") in cats]
                        lo = self._qfloat(q, "since_us")
                        if lo is not None:
                            events = [e for e in events
                                      if e["ts_us"] >= lo]
                        doc = trace_document(events)
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    elif path == "/tenants":
                        sched = server._sched()
                        if sched is None:
                            self._send(404, b"no scheduler on this "
                                            b"context\n", "text/plain")
                        else:
                            self._send(200,
                                       json.dumps(sched.tenants_info(),
                                                  default=str).encode(),
                                       "application/json")
                    elif path == "/slo":
                        slo = getattr(server._ctx, "slo", None)
                        if slo is None:
                            self._send(404, b"no SLO engine on this "
                                            b"context\n", "text/plain")
                        else:
                            self._send(200,
                                       json.dumps(slo.report(),
                                                  default=str).encode(),
                                       "application/json")
                    elif path == "/history":
                        hist = getattr(server._ctx, "history", None)
                        if hist is None:
                            self._send(404, b"no stats history on this "
                                            b"context\n", "text/plain")
                        else:
                            since = self._qfloat(q, "since_s")
                            keys = [k for part in q.get("keys", [])
                                    for k in part.split(",") if k] or None
                            self._send(200,
                                       json.dumps(hist.snapshot(
                                           since, keys)).encode(),
                                       "application/json")
                    elif path == "/tune":
                        tuner = getattr(server._ctx, "tuner", None)
                        if tuner is None:
                            self._send(404, b"no autotuner on this "
                                            b"context (tune=False)\n",
                                       "text/plain")
                        else:
                            self._send(200,
                                       json.dumps(tuner.stats(),
                                                  default=str).encode(),
                                       "application/json")
                    elif path == "/cluster":
                        view = getattr(server._ctx, "cluster_view", None)
                        if view is None:
                            self._send(404, b"no cluster view on this "
                                            b"context (attach_cluster)\n",
                                       "text/plain")
                        else:
                            self._send(200,
                                       json.dumps(view.snapshot(),
                                                  default=str).encode(),
                                       "application/json")
                    elif path == "/flight":
                        dump = q.get("dump", ["0"])[0] not in ("0", "", "no")
                        self._send(200,
                                   json.dumps(server._flight_doc(dump),
                                              default=str).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found: try /metrics /stats "
                                        b"/trace /flight /tenants /slo "
                                        b"/tune /history /cluster\n",
                                   "text/plain")
                except _BadQuery as e:
                    with contextlib.suppress(Exception):
                        self._send(400, f"bad query: {e}\n".encode(),
                                   "text/plain")
                # surfaced: repr(e) is the 500 body
                except Exception as e:  # a scrape must never kill the server
                    with contextlib.suppress(Exception):
                        self._send(500, repr(e).encode(), "text/plain")

            def do_POST(self) -> None:  # noqa: N802 (http.server API)
                path, _, _ = self.path.partition("?")
                try:
                    if path != "/tenants":
                        self._send(404, b"POST supports /tenants only\n",
                                   "text/plain")
                        return
                    sched = server._sched()
                    if sched is None:
                        self._send(404, b"no scheduler on this context\n",
                                   "text/plain")
                        return
                    n = int(self.headers.get("Content-Length") or 0)
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                        if not isinstance(body, dict):
                            raise ValueError("body must be a JSON object")
                    except (ValueError, json.JSONDecodeError) as e:
                        self._send(400, f"bad body: {e}\n".encode(),
                                   "text/plain")
                        return
                    try:
                        out = server._tenants_op(sched, body)
                    except (ValueError, TypeError) as e:
                        # malformed FIELDS (empty name, weight:'abc',
                        # byte_burst:null) are the client's fault — 400,
                        # same as a malformed body, not a 500 server fault
                        self._send(400, f"bad field: {e}\n".encode(),
                                   "text/plain")
                        return
                    if out is None:
                        self._send(400, b"op must be 'register' or "
                                        b"'drain'\n", "text/plain")
                    else:
                        self._send(200, json.dumps(out,
                                                   default=str).encode(),
                                   "application/json")
                # surfaced as the 500 body, as in do_GET
                except Exception as e:  # same 500-survival contract as GET
                    with contextlib.suppress(Exception):
                        self._send(500, repr(e).encode(), "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port: int = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="strom-metrics", daemon=True)
        self._thread.start()

    # -- route bodies (exceptions bubble to the handler's 500) --------------
    def _call_stats(self, only: "list[str] | None" = None) -> dict:
        if self._stats_fn is None:
            return {}
        if only is not None:
            try:
                return self._stats_fn(sections=only)
            except TypeError:  # stats_fn predates section selection
                pass
        return self._stats_fn()

    def _section_texts(self, only: "list[str] | None") -> list[str]:
        """Rendered exposition per wanted section, served from the TTL
        cache; only STALE wanted sections are recomputed (one stats_fn
        call for the whole stale set). First scrape (section names
        unknown) computes everything once to learn them."""
        from strom_torch.utils.stats import sections_prometheus

        with self._cache_lock:
            known = list(self._known_sections)
        if not known:
            secs = self._call_stats()
            now = time.monotonic()
            with self._cache_lock:
                self._known_sections = [s for s in secs
                                        if s not in _NON_EXPOSITION_SECTIONS]
                for name, vals in secs.items():
                    if name in _NON_EXPOSITION_SECTIONS:
                        continue
                    self._sec_cache[name] = (
                        now, sections_prometheus({name: vals}))
                known = list(self._known_sections)
        wanted = [s for s in (only if only is not None else known)
                  if s not in _NON_EXPOSITION_SECTIONS]
        now = time.monotonic()
        with self._cache_lock:
            stale = [s for s in wanted
                     if s not in self._sec_cache
                     or now - self._sec_cache[s][0] >= self._ttl]
        if stale:
            secs = self._call_stats(stale)
            now = time.monotonic()
            with self._cache_lock:
                for name, vals in secs.items():
                    if name in _NON_EXPOSITION_SECTIONS:
                        continue
                    self._sec_cache[name] = (
                        now, sections_prometheus({name: vals}))
                    if name not in self._known_sections:
                        self._known_sections.append(name)
        with self._cache_lock:
            return [self._sec_cache[s][1] for s in wanted
                    if s in self._sec_cache]

    def _refresh_slo(self) -> None:
        """The ``slo_*`` gauges are written by ``SloEngine.report()`` —
        without this, only a ``/slo`` hit would refresh them, and the
        documented /metrics contract (labeled burn-rate gauges) would show
        stale zeros to a Prometheus-only deployment. TTL-guarded like the
        section cache so rapid scrapes don't recompute the windows."""
        slo = getattr(self._ctx, "slo", None)
        if slo is None:
            return
        now = time.monotonic()
        with self._cache_lock:
            if now - self._slo_refreshed < self._ttl:
                return
            self._slo_refreshed = now
        with contextlib.suppress(Exception):
            slo.report()

    def _metrics(self, only: "list[str] | None" = None) -> str:
        from strom_torch.utils.stats import global_stats

        self._refresh_slo()
        return global_stats.prometheus() + "".join(self._section_texts(only))

    def _stats(self, only: "list[str] | None" = None) -> dict:
        from strom_torch.utils.stats import global_stats

        return {"sections": self._call_stats(only),
                "global": global_stats.snapshot(),
                "scopes": global_stats.scopes_snapshot(),
                "events_dropped": self._ring.events_dropped}

    def _sched(self):
        """The owning context's IoScheduler, if any (the /tenants routes)."""
        return getattr(self._ctx, "scheduler", None)

    def _tenants_op(self, sched, body: dict) -> "dict | None":
        """Execute one POST /tenants op; None = unknown op (→ 400).
        ``register`` goes through the context when one is attached so
        hot-cache partitions are carved too."""
        op = body.get("op")
        if op == "register":
            name = str(body.get("name") or "")
            if not name:
                raise ValueError("register needs a non-empty 'name'")
            kw = {k: body[k] for k in ("priority", "weight", "byte_rate",
                                       "byte_burst", "iops",
                                       "hot_cache_bytes") if k in body}
            cast = {k: (int(v) if k in ("weight", "hot_cache_bytes")
                        else float(v) if k in ("byte_rate", "byte_burst",
                                               "iops")
                        else str(v))
                    for k, v in kw.items()}
            if self._ctx is not None \
                    and hasattr(self._ctx, "register_tenant"):
                t = self._ctx.register_tenant(name, **cast)
            else:
                t = sched.register(name, **cast)
            return t.info()
        if op == "drain":
            name = body.get("name")  # None = the default tenant
            timeout = float(body.get("timeout_s", 30.0))
            return {"tenant": name or "default",
                    "drained": sched.drain(name, timeout_s=timeout)}
        return None

    def _flight_doc(self, dump: bool = False) -> dict:
        if self._flight is not None:
            doc = self._flight.capture("on_demand")
            if dump:
                doc["bundle_path"] = self._flight.dump("on_demand")
            return doc
        from strom_torch.obs.flight import capture_doc

        doc = capture_doc(ctx=self._ctx, ring=self._ring)
        if dump:
            doc["bundle_path"] = None  # no recorder → no flight_dir to hit
        return doc

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
