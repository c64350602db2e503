"""Cluster observability: metrics federation and a fleet health watchdog
(the port's copy of ``strom/obs/federation.py``).

A fleet of per-host processes each serves its own ``/stats``. A
:class:`ClusterView` polls every worker's ``/stats?sections=...``, merges
the per-host registry snapshots into per-host rows and one cluster
aggregate, and watches each host's progress.

- **aggregate == sum.** :func:`merge_snapshots` sums counters and gauges
  and merges histograms bucket by bucket (``_Histogram.add_buckets``), so
  every aggregate series is the element-wise sum of the hosts' series.
  Percentiles and means are derived again from the merged buckets, never
  averaged across hosts (an average of p99s is no p99).
- **Stale data ages out.** A host snapshot older than *stale_s* stops
  contributing and flips the host unhealthy.
- **Scrapes never hold the lock.** The ``obs.federation`` lock guards
  in-memory state only; every socket (scrapes, flight triggers) is used
  outside it.

A host is unhealthy when its scrape fails or ages past *stale_s*, or when
its progress counters (*progress_keys*) have not moved for *stall_s*. On
the healthy → unhealthy edge the view asks the host for ``/flight?dump=1``
(best effort: a killed worker cannot serve it) and dumps the coordinator's
own FlightRecorder with the host in the note. Served as ``GET /cluster``.
The default progress key is ``ssd2gpu_bytes``, the port's name for the
reference's ``ssd2tpu_bytes``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import urllib.request
from typing import Callable, Mapping

from strom_torch.utils.locks import make_lock
from strom_torch.utils.stats import _Histogram, global_stats

# the cluster columns (the reference's dist bench arm emits them)
FED_FIELDS = (
    "cluster_hosts",
    "cluster_hosts_unhealthy",
    "cluster_trace_linked_ratio",
    "cluster_scrape_lag_p99_us",
)

# registry-snapshot suffixes derived from one histogram (stats.snapshot's
# scheme): summed naively they'd be nonsense (sum of p99s), so the merge
# re-derives them from the merged buckets instead
_HIST_DERIVED = ("_p50_us", "_p99_us", "_mean_us", "_total_us", "_count")

_SCRAPE_TIMEOUT_S = 2.0


def _is_hist_derived(key: str, stems: set[str]) -> bool:
    for suf in _HIST_DERIVED:
        if key.endswith(suf) and key[: -len(suf)] in stems:
            return True
    return False


def merge_snapshots(snaps: Mapping[str, Mapping]) -> dict:
    """Merge per-host flat registry snapshots (``StatsRegistry.snapshot``
    shape) into one cluster aggregate: counters/gauges sum, ``*_hist``
    bucket lists merge element-wise (``add_buckets`` convention) and their
    percentile/mean/total/count siblings are re-derived from the merged
    histogram. Hosts missing a key simply don't contribute (missing-host
    tolerance); non-numeric leaves are dropped."""
    stems: set[str] = set()
    for snap in snaps.values():
        for k, v in snap.items():
            if k.endswith("_hist") and isinstance(v, (list, tuple)):
                stems.add(k[: -len("_hist")])
    out: dict = {}
    hists: dict[str, _Histogram] = {}
    for snap in snaps.values():
        for k, v in snap.items():
            if k.endswith("_hist") and isinstance(v, (list, tuple)):
                stem = k[: -len("_hist")]
                h = hists.get(stem)
                if h is None:
                    h = hists[stem] = _Histogram()
                h.add_buckets(v, float(snap.get(stem + "_total_us", 0.0)))
            elif _is_hist_derived(k, stems):
                continue
            elif isinstance(v, bool):
                out[k] = out.get(k, 0) + int(v)
            elif isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
    for stem, h in hists.items():
        out[stem + "_hist"] = list(h.buckets)
        out[stem + "_count"] = h.count
        out[stem + "_total_us"] = h.total_us
        out[stem + "_mean_us"] = h.mean_us
        out[stem + "_p50_us"] = h.percentile(0.50)
        out[stem + "_p99_us"] = h.percentile(0.99)
    return out


def _http_fetch(addr: str, sections: tuple[str, ...]) -> dict:
    url = f"http://{addr}/stats?sections={','.join(sections)}"
    with urllib.request.urlopen(url, timeout=_SCRAPE_TIMEOUT_S) as resp:
        return json.loads(resp.read())


def _http_flight(addr: str) -> None:
    url = f"http://{addr}/flight?dump=1"
    with urllib.request.urlopen(url, timeout=_SCRAPE_TIMEOUT_S) as resp:
        resp.read()


class _HostState:
    __slots__ = ("addr", "snap", "snap_t", "progress", "progress_t",
                 "healthy", "scrapes", "scrape_failures", "flight_fired")

    def __init__(self, addr: str) -> None:
        self.addr = addr
        self.snap: dict | None = None  # last good {"sections","global",...}
        self.snap_t = float("-inf")  # monotonic time of last good scrape
        self.progress: tuple | None = None
        self.progress_t = time.monotonic()
        self.healthy = True  # grace: unknown ≠ unhealthy until stale_s
        self.scrapes = 0
        self.scrape_failures = 0
        self.flight_fired = False


class ClusterView:
    """Poll N worker ``/stats`` endpoints; merge, watch, serve.

    *hosts* maps host id → ``"ip:port"`` metrics address. *fetch_fn* /
    *flight_fn* are injectable for tests (defaults: HTTP ``/stats`` and
    ``/flight?dump=1``). *recorder* is the coordinator's own FlightRecorder:
    dumped with ``reason="cluster_unhealthy"`` when a host goes bad, so the
    incident leaves a local bundle even when the remote host cannot serve
    its own. *publish* mirrors the FED_FIELDS into ``global_stats`` gauges
    so the coordinator's /metrics and /history carry them."""

    def __init__(self, hosts: Mapping[str, str], *,
                 fetch_fn: Callable[[str], dict] | None = None,
                 flight_fn: Callable[[str], None] | None = None,
                 recorder=None, interval_s: float = 1.0,
                 stale_s: float | None = None, stall_s: float = 10.0,
                 progress_keys: tuple[str, ...] = ("ssd2gpu_bytes",
                                                   "peer_serves"),
                 sections: tuple[str, ...] = ("dist", "sched", "slo",
                                              "steps"),
                 publish: bool = True, start: bool = True) -> None:
        self._sections = tuple(sections)
        self._fetch = fetch_fn or (lambda a: _http_fetch(a, self._sections))
        self._flight = flight_fn or _http_flight
        self._recorder = recorder
        self._interval_s = max(float(interval_s), 0.05)
        self._stale_s = (3.0 * self._interval_s + _SCRAPE_TIMEOUT_S
                         if stale_s is None else float(stale_s))
        self._stall_s = float(stall_s)
        self._progress_keys = tuple(progress_keys)
        self._publish = publish
        # held only around in-memory state mutation — NEVER across the
        # scrape/flight sockets
        self._lock = make_lock("obs.federation")
        self._hosts = {str(h): _HostState(str(a)) for h, a in hosts.items()}
        self._lag = _Histogram()  # scrape wall time, all hosts
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(target=self._run,
                                            name="strom-cluster",
                                            daemon=True)
            self._thread.start()

    # -- polling ------------------------------------------------------------
    def _run(self) -> None:
        while not self._closed.is_set():
            self.poll_now()
            self._closed.wait(self._interval_s)

    def poll_now(self) -> None:
        """One synchronous scrape sweep + health evaluation (the loop body;
        callable directly for deterministic tests)."""
        results: dict[str, tuple[dict | None, float]] = {}
        for host, st in list(self._hosts.items()):
            t0 = time.perf_counter()
            snap = None
            with contextlib.suppress(Exception):
                snap = self._fetch(st.addr)
            results[host] = (snap, (time.perf_counter() - t0) * 1e6)
        now = time.monotonic()
        to_flight: list[str] = []
        with self._lock:
            for host, (snap, lag_us) in results.items():
                st = self._hosts[host]
                st.scrapes += 1
                self._lag.observe_us(lag_us)
                if isinstance(snap, dict):
                    st.snap = snap
                    st.snap_t = now
                    prog = self._progress_of(snap)
                    if prog != st.progress:
                        st.progress = prog
                        st.progress_t = now
                else:
                    st.scrape_failures += 1
                healthy = self._evaluate(st, now)
                if st.healthy and not healthy and not st.flight_fired:
                    st.flight_fired = True
                    to_flight.append(host)
                if healthy:
                    st.flight_fired = False
                st.healthy = healthy
            fields = self._fields_locked()
        if self._publish:
            for k, v in fields.items():
                global_stats.set_gauge(k, v)
        for host in to_flight:  # sockets strictly outside the lock
            self._on_unhealthy(host)

    def _progress_of(self, snap: dict) -> tuple:
        flat = snap.get("global", snap)
        return tuple(flat.get(k) for k in self._progress_keys
                     if k in flat)

    def _evaluate(self, st: _HostState, now: float) -> bool:
        if now - st.snap_t > self._stale_s:
            # includes the never-scraped case once the grace window passes
            return st.snap is None and now - st.progress_t <= self._stale_s
        if st.progress and now - st.progress_t > self._stall_s:
            return False
        return True

    def _on_unhealthy(self, host: str) -> None:
        st = self._hosts[host]
        with contextlib.suppress(Exception):
            self._flight(st.addr)
        if self._recorder is not None:
            with contextlib.suppress(Exception):
                self._recorder.dump("cluster_unhealthy", note=f"host={host}")

    # -- views --------------------------------------------------------------
    def _fields_locked(self) -> dict:
        serves = traced = 0
        for st in self._hosts.values():
            dist = (st.snap or {}).get("sections", {}).get("dist") or {}
            serves += int(dist.get("peer_serves", 0) or 0)
            traced += int(dist.get("peer_serves_traced", 0) or 0)
        return {
            "cluster_hosts": len(self._hosts),
            "cluster_hosts_unhealthy": sum(
                1 for st in self._hosts.values() if not st.healthy),
            "cluster_trace_linked_ratio":
                round(traced / serves, 4) if serves else 0.0,
            "cluster_scrape_lag_p99_us": self._lag.percentile(0.99),
        }

    def stats(self) -> dict:
        """The FED_FIELDS dict."""
        with self._lock:
            return self._fields_locked()

    def snapshot(self) -> dict:
        """The ``/cluster`` document: per-host rows, the summed aggregate of
        every fresh host's global registry snapshot, and the FED fields."""
        now = time.monotonic()
        with self._lock:
            rows: dict[str, dict] = {}
            fresh: dict[str, dict] = {}
            for host, st in self._hosts.items():
                snap = st.snap or {}
                secs = snap.get("sections", {}) or {}
                flat = snap.get("global", {}) or {}
                dist = secs.get("dist") or {}
                steps = secs.get("steps") or {}
                hits = float(dist.get("peer_hits", 0) or 0)
                misses = float(dist.get("peer_misses", 0) or 0)
                age = now - st.snap_t if st.snap is not None else None
                rows[host] = {
                    "addr": st.addr,
                    "healthy": st.healthy,
                    "age_s": round(age, 3) if age is not None else None,
                    "scrapes": st.scrapes,
                    "scrape_failures": st.scrape_failures,
                    "goodput_pct": steps.get("goodput_pct"),
                    "peer_hit_ratio":
                        round(hits / (hits + misses), 4)
                        if hits + misses else None,
                    "sched_queue_wait_p99_us":
                        flat.get("sched_queue_wait_p99_us"),
                    "slo_burning": flat.get("slo_burning"),
                }
                if st.snap is not None and now - st.snap_t <= self._stale_s:
                    fresh[host] = flat
            fields = self._fields_locked()
        return {"hosts": rows, "aggregate": merge_snapshots(fresh), **fields}

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
