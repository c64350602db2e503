"""Per-tenant SLO engine: declarative targets and multi-window burn rates
(the port's copy of ``strom/obs/slo.py``).

- **Targets** are per tenant (:class:`SloTarget`): a request is *good* when
  its wall latency and its accumulated scheduler queue wait both sit under
  the target's thresholds and it did not fail; the objective is "at least
  ``objective_pct`` % of requests good".
- **Burn rate** = (bad fraction) / (allowed bad fraction), over two sliding
  windows, fast (5 min) and slow (1 h), bucketed at ``bucket_s``. A tenant
  is **burning** when both exceed the threshold: the fast window catches
  the spike, the slow one keeps a brief blip from alerting.
- Surfaced three ways: ``slo_*`` gauges in each tenant's scope (labelled
  on /metrics, the aggregate the worst tenant), the live server's ``/slo``
  route (:meth:`SloEngine.report`), and the scheduler's ``slo_hook``,
  which flags burning tenants on ``tenants_info()`` rows.

Requests feed the engine through the request observer
(:func:`strom_torch.obs.request.add_observer`), one per context; the clock
is injectable so the window arithmetic is testable.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

from strom_torch.utils.locks import make_lock

# per-tenant gauges the engine writes into tenant scopes
SLO_FIELDS = (
    "slo_burn_fast",
    "slo_burn_slow",
    "slo_good_pct",
    "slo_burning",
)


@dataclasses.dataclass(frozen=True)
class SloTarget:
    """A tenant's objective. The defaults are loose on purpose: a tenant
    nobody configured burns only when something is really wrong."""

    gather_p99_us: float = 2_000_000.0   # request wall above this = bad
    queue_wait_p99_us: float = 1_000_000.0  # accumulated sched wait cap
    objective_pct: float = 99.0          # % of requests that must be good
    # minimum stall-attribution goodput (0 = not enforced): report()
    # compares it with the context's goodput_fn as goodput_ok
    goodput_pct: float = 0.0

    @property
    def budget_frac(self) -> float:
        return max(1.0 - self.objective_pct / 100.0, 1e-6)


class SloEngine:
    """Sliding-window good/bad accounting per tenant."""

    #: burn-rate alert threshold (both windows must exceed it): 1.0 spends
    #: the budget exactly as fast as allowed
    BURN_THRESHOLD = 1.0

    def __init__(self, *, fast_s: float = 300.0, slow_s: float = 3600.0,
                 bucket_s: float = 10.0, clock=time.monotonic,
                 default_target: "SloTarget | None" = None,
                 goodput_fn=None):
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.bucket_s = max(float(bucket_s), 0.1)
        self._clock = clock
        self._default = default_target or SloTarget()
        # a callable giving the context's goodput_pct (None = unknown)
        self._goodput_fn = goodput_fn
        self._targets: dict[str, SloTarget] = {}
        self._lock = make_lock("obs.slo")
        # tenant -> deque of [bucket index, good, bad], oldest first,
        # trimmed to the slow window
        self._buckets: dict[str, deque] = {}

    # -- configuration -------------------------------------------------------
    def set_target(self, tenant: str, **kw) -> SloTarget:
        """Override (or refine) one tenant's target; an unknown keyword
        raises (a mistyped threshold must not default silently)."""
        with self._lock:
            base = self._targets.get(tenant, self._default)
            t = dataclasses.replace(base, **kw)
            self._targets[tenant] = t
            return t

    def target(self, tenant: str) -> SloTarget:
        with self._lock:
            return self._targets.get(tenant, self._default)

    # -- ingest --------------------------------------------------------------
    def observe(self, tenant: str, latency_us: float, *,
                queue_wait_us: float = 0.0, error: bool = False) -> None:
        t = self.target(tenant)
        bad = (error or latency_us > t.gather_p99_us
               or queue_wait_us > t.queue_wait_p99_us)
        bi = int(self._clock() / self.bucket_s)
        with self._lock:
            dq = self._buckets.get(tenant)
            if dq is None:
                dq = self._buckets[tenant] = deque()
            if not dq or dq[-1][0] != bi:
                dq.append([bi, 0, 0])
                self._trim_locked(dq, bi)
            dq[-1][1 + int(bad)] += 1

    def observe_request(self, req) -> None:
        """The request observer's entry point. Only data-path requests
        count: a "step" request's wall is mostly the consumer's compute."""
        if req.kind == "step":
            return
        self.observe(req.tenant, req.dur_us,
                     queue_wait_us=req.queue_wait_us,
                     error=req.error is not None)

    def _trim_locked(self, dq: deque, now_bi: int) -> None:
        horizon = now_bi - int(self.slow_s / self.bucket_s) - 1
        while dq and dq[0][0] < horizon:
            dq.popleft()

    # -- window math ---------------------------------------------------------
    def _window_locked(self, dq: deque, window_s: float, now_bi: int
                       ) -> tuple[int, int]:
        lo = now_bi - int(window_s / self.bucket_s)
        good = bad = 0
        for bi, g, b in reversed(dq):
            if bi < lo:
                break
            good += g
            bad += b
        return good, bad

    def burn_rates(self, tenant: str) -> tuple[float, float]:
        """(fast, slow) burn rates: the window's bad fraction over the
        tenant's error budget; 0.0 without traffic."""
        t = self.target(tenant)
        bi = int(self._clock() / self.bucket_s)
        with self._lock:
            dq = self._buckets.get(tenant)
            if not dq:
                return 0.0, 0.0
            out = []
            for w in (self.fast_s, self.slow_s):
                good, bad = self._window_locked(dq, w, bi)
                n = good + bad
                out.append((bad / n / t.budget_frac) if n else 0.0)
        return out[0], out[1]

    def burning(self, tenant: str) -> bool:
        fast, slow = self.burn_rates(tenant)
        return fast > self.BURN_THRESHOLD and slow > self.BURN_THRESHOLD

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(set(self._buckets) | set(self._targets))

    # -- surfacing -----------------------------------------------------------
    def report(self) -> dict:
        """The ``/slo`` body: a row per tenant. Refreshes the SLO_FIELDS
        gauges in each tenant's scope, so /metrics carries the same
        numbers as labelled series."""
        from strom_torch.utils.stats import global_stats

        bi = int(self._clock() / self.bucket_s)
        goodput = None
        if self._goodput_fn is not None:
            try:
                goodput = self._goodput_fn()
            except Exception:
                # None is the report's "goodput unknown" (a closing
                # context may refuse the read)
                goodput = None
        rows: dict[str, dict] = {}
        worst_fast = worst_slow = 0.0
        worst_good_pct = 100.0
        any_burning = False
        for name in self.tenants():
            t = self.target(name)
            fast, slow = self.burn_rates(name)
            with self._lock:
                dq = self._buckets.get(name) or ()
                good, bad = self._window_locked(deque(dq), self.slow_s, bi)
            n = good + bad
            good_pct = round(100.0 * good / n, 3) if n else 100.0
            burning = fast > self.BURN_THRESHOLD and slow > self.BURN_THRESHOLD
            rows[name] = {
                "target": dataclasses.asdict(t),
                "requests": n,
                "bad": bad,
                "slo_good_pct": good_pct,
                "slo_burn_fast": round(fast, 4),
                "slo_burn_slow": round(slow, 4),
                "slo_burning": burning,
                "goodput_pct": goodput,
                "goodput_ok": (goodput is None or t.goodput_pct <= 0
                               or goodput >= t.goodput_pct),
            }
            scope = global_stats.scoped(
                tenant=name if name != "default" else None)
            scope.set_gauge("slo_burn_fast", round(fast, 4))
            scope.set_gauge("slo_burn_slow", round(slow, 4))
            scope.set_gauge("slo_good_pct", good_pct)
            scope.set_gauge("slo_burning", int(burning))
            worst_fast = max(worst_fast, fast)
            worst_slow = max(worst_slow, slow)
            worst_good_pct = min(worst_good_pct, good_pct)
            any_burning = any_burning or burning
        # the unlabelled aggregate is the worst tenant, not whichever
        # scope wrote last: an alert on it must never miss a burning tenant
        if rows:
            global_stats.set_gauge("slo_burn_fast", round(worst_fast, 4))
            global_stats.set_gauge("slo_burn_slow", round(worst_slow, 4))
            global_stats.set_gauge("slo_good_pct", worst_good_pct)
            global_stats.set_gauge("slo_burning", int(any_burning))
        return {"windows_s": {"fast": self.fast_s, "slow": self.slow_s},
                "burn_threshold": self.BURN_THRESHOLD,
                "tenants": rows}

    def ok(self) -> bool:
        """True when no tenant is burning (the bench's ``slo_ok`` column)."""
        return not any(self.burning(t) for t in self.tenants())

    def stats(self) -> dict:
        """The ``slo`` section of ``StromContext.stats()``."""
        names = self.tenants()
        burns = [self.burn_rates(t) for t in names]
        return {
            "slo_tenants": len(names),
            "slo_tenants_burning": sum(int(f > self.BURN_THRESHOLD
                                           and s > self.BURN_THRESHOLD)
                                       for f, s in burns),
            "slo_worst_burn_fast": round(max((f for f, _ in burns),
                                             default=0.0), 4),
            "slo_worst_burn_slow": round(max((s for _, s in burns),
                                             default=0.0), 4),
        }
