"""Tail-based exemplar sampling (the port's copy of
``strom/obs/exemplars.py``): keep the span trees worth keeping.

Recording every request's full span tree would reproduce the event ring's
memory problem one level up; recording none reproduces its diagnosis
problem ("p99 is high" with nothing to open). Tail-based sampling keeps
exactly the requests an operator would ask about:

- **slow**: the request's wall time sits strictly above its tenant's
  rolling p99 (a per-tenant sliding window of recent request latencies,
  so one tenant's heavy gathers never define another's "slow");
- **throttled**: any scheduler grant inside it waited on a budget bucket;
- **errored**: the request raised.

Everything else is discarded at ~zero amortized cost: one deque append
for the rolling window plus one comparison against a cached p99 that is
re-sorted only every 16th offer per (tenant, kind). Retained exemplars are
bounded per tenant (drop-oldest), dumped inside flight-recorder bundles
(``exemplars.json``), and snapshot-able for tools. The store is
process-global, the same singleton shape as the event ring — requests
offer themselves at finish (:mod:`strom_torch.obs.request`).
"""

from __future__ import annotations

from collections import deque

from strom_torch.utils.locks import make_lock

# flat numeric leaves for the ``exemplars`` stats section + flight samples
# (single-sourced, same contract as FLIGHT_FIELDS / STALL_FIELDS)
EXEMPLAR_FIELDS = (
    "exemplars_offered",
    "exemplars_retained",
    "exemplars_discarded",
    "exemplars_slow",
    "exemplars_throttled",
    "exemplars_errored",
)


class ExemplarStore:
    """Bounded per-tenant store of slow/throttled/errored request trees."""

    def __init__(self, *, per_tenant: int = 8, window: int = 256,
                 min_window: int = 16):
        self.per_tenant = int(per_tenant)
        self.window = int(window)
        # below this many observed requests a tenant has no meaningful p99
        # yet: only throttled/errored requests are retained (a cold store
        # must not keep every warm-up request as "slow")
        self.min_window = int(min_window)
        self._lock = make_lock("obs.exemplars")
        self._kept: dict[str, deque] = {}       # tenant -> exemplar docs
        # latency windows are keyed (tenant, kind): a tenant's "step"
        # requests (consumer compute included) must not define "slow" for
        # its gathers, or gathers would never clear the bar
        self._lat: dict[tuple, deque] = {}      # (tenant, kind) -> dur_us
        # p99 is re-sorted only every _P99_REFRESH appends per key — the
        # steady-state offer() cost stays one append + one comparison
        self._p99_cache: dict[tuple, tuple[float, int]] = {}  # key->(p99,at)
        self._seen: dict[tuple, int] = {}       # appends per key
        self.offered = 0
        self.retained = 0
        self.slow = 0
        self.throttled = 0
        self.errored = 0

    # -- policy --------------------------------------------------------------
    #: appends per latency window between exact p99 recomputes
    _P99_REFRESH = 16

    def _p99_locked(self, key: tuple) -> "float | None":
        win = self._lat.get(key)
        if win is None or len(win) < self.min_window:
            return None
        vals = sorted(win)
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    def _p99_cached_locked(self, key: tuple) -> "float | None":
        """The offer()-path threshold: the exact p99, re-sorted at most
        every :attr:`_P99_REFRESH` appends so the per-request cost is O(1)
        amortized instead of an O(n log n) sort under the global lock."""
        seen = self._seen.get(key, 0)
        cached = self._p99_cache.get(key)
        if cached is not None and seen - cached[1] < self._P99_REFRESH:
            return cached[0]
        p99 = self._p99_locked(key)
        if p99 is not None:
            self._p99_cache[key] = (p99, seen)
        return p99

    def tenant_p99_us(self, tenant: str, kind: str = "gather"
                      ) -> "float | None":
        """The current rolling-p99 threshold for (*tenant*, *kind*) — None
        while the window is still too small to define one."""
        with self._lock:
            return self._p99_locked((tenant, kind))

    def offer(self, req) -> bool:
        """Tail-sampling decision for a finished Request: True = retained.
        The latency window is updated AFTER the decision, so a slow request
        is judged against the history it lagged, not one it already moved."""
        dur = req.dur_us
        key = (req.tenant, req.kind)
        with self._lock:
            self.offered += 1
            p99 = self._p99_cached_locked(key)
            # strictly above: on uniform traffic p99 equals every sample,
            # and >= would retain the whole steady state as "slow"
            slow = p99 is not None and dur > p99
            keep = slow or req.throttled or req.error is not None
            win = self._lat.get(key)
            if win is None:
                win = self._lat[key] = deque(maxlen=self.window)
            win.append(dur)
            self._seen[key] = self._seen.get(key, 0) + 1
            if not keep:
                return False
            self.retained += 1
            if slow:
                self.slow += 1
            if req.throttled:
                self.throttled += 1
            if req.error is not None:
                self.errored += 1
            kept = self._kept.get(req.tenant)
            if kept is None:
                kept = self._kept[req.tenant] = deque(
                    maxlen=self.per_tenant)
            doc = req.to_doc()
            doc["why"] = [w for w, on in
                          (("slow", slow), ("throttled", req.throttled),
                           ("error", req.error is not None)) if on]
            kept.append(doc)
        return True

    # -- inspection ----------------------------------------------------------
    def snapshot(self) -> dict:
        """{'tenants': {name: [exemplar docs, oldest first]}, counters} —
        the /flight capture member and the bundle's ``exemplars.json``."""
        with self._lock:
            return {"tenants": {t: list(d) for t, d in self._kept.items()},
                    **self.stats_locked()}

    def stats_locked(self) -> dict:
        return {
            "exemplars_offered": self.offered,
            "exemplars_retained": self.retained,
            "exemplars_discarded": self.offered - self.retained,
            "exemplars_slow": self.slow,
            "exemplars_throttled": self.throttled,
            "exemplars_errored": self.errored,
        }

    def stats(self) -> dict:
        """Flat EXEMPLAR_FIELDS leaves (the ``exemplars`` stats section)."""
        with self._lock:
            return self.stats_locked()

    def exemplars(self, tenant: "str | None" = None) -> list[dict]:
        with self._lock:
            if tenant is not None:
                return list(self._kept.get(tenant, ()))
            out: list[dict] = []
            for d in self._kept.values():
                out.extend(d)
        out.sort(key=lambda e: e.get("t0_us", 0.0))
        return out

    def clear(self) -> None:
        with self._lock:
            self._kept.clear()
            self._lat.clear()
            self._p99_cache.clear()
            self._seen.clear()
            self.offered = self.retained = 0
            self.slow = self.throttled = self.errored = 0


# the process-wide store every finished request offers itself to
store = ExemplarStore()
