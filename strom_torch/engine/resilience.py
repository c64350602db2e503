"""Resilience primitives (the port's copy of
``strom/engine/resilience.py``): retry policy, circuit breaker, hedge
control.

The policy half of the failure story, shared by the engine layer
(per-piece retry with backoff, budget and deadline,
:mod:`strom_torch.engine.base`) and the delivery layer (a per-engine
circuit breaker and failover, :mod:`strom_torch.delivery.resilient`):

- :func:`classify_errno`: transient against permanent. Transient errors
  (EIO, EAGAIN, ETIMEDOUT, ...) are retried within the budget; permanent
  ones (EBADF, EINVAL, EFAULT, ...) fail at once.
- :class:`RetryPolicy`: exponential backoff with seeded jitter, capped,
  under a per-gather retry budget, so a sick device produces a bounded
  number of resubmits per transfer.
- :class:`CircuitBreaker`: a per-engine error-rate trip over a rolling
  window, closed → open → half-open. While open the delivery layer
  reroutes reads to the fallback engine; half-open lets probes through,
  and enough probe successes close it.
- :class:`HedgeController`: an adaptive hedge threshold from a rolling
  latency window. The streamed gather fires no hedge yet: the class is
  here for its threshold arithmetic.

Everything here takes an injectable clock, and writes its counters
through a telemetry scope (labelled and aggregate).
"""

from __future__ import annotations

import contextlib
import errno as _errno
import random
import time
from collections import deque
from typing import Callable

from strom_torch.utils.locks import make_lock

# Counters the resilience layer feeds, under the reference's names: the
# context's stats() and the chaos measurement read this tuple, so a
# restyled spelling cannot fork a column from its producer.
RESILIENCE_FIELDS = (
    "chunk_retries",
    "retry_backoff_waits",
    "retry_budget_exhausted",
    "deadline_exceeded",
    "engine_stall_timeouts",
    "breaker_state",
    "breaker_trips",
    "breaker_probes",
    "breaker_recoveries",
    "failover_reads",
    "failover_bytes",
    "hedges_fired",
    "hedges_won",
    "hedge_wasted_bytes",
    "faults_injected",
)

# The chaos measurement's columns (the reference's bench_chaos names)
CHAOS_BENCH_FIELDS = (
    "chaos_ok",
    "chaos_slowdown",
    "chaos_clean_images_per_s",
    "chaos_faulty_images_per_s",
    "chaos_faults_injected",
    "chaos_chunk_retries",
    "chaos_failover_reads",
    "chaos_breaker_trips",
    "chaos_hedges_fired",
)

# errnos worth a resubmit: the device/link may answer next time.
# ECONNREFUSED/ECONNRESET/EPIPE are the network-fault spellings of the
# chaos_net preset: a refused peer may be back next cooldown.
TRANSIENT_ERRNOS = frozenset({
    _errno.EIO, _errno.EAGAIN, _errno.EINTR, _errno.ETIMEDOUT,
    _errno.ENXIO, _errno.EBUSY, _errno.ENODATA,
    _errno.ECONNREFUSED, _errno.ECONNRESET, _errno.EPIPE,
})
# errnos where a retry is guaranteed to fail identically
PERMANENT_ERRNOS = frozenset({
    _errno.EBADF, _errno.EINVAL, _errno.EFAULT, _errno.ENOMEM,
    _errno.ENOSPC, _errno.ECANCELED, _errno.EPERM, _errno.EACCES,
})


def classify_errno(err: int) -> str:
    """'transient' or 'permanent' for a positive errno. Unknown errnos
    count as transient: optimism costs one bounded backoff; pessimism
    fails a gather that a resubmit would have saved."""
    e = abs(int(err))
    if e in PERMANENT_ERRNOS:
        return "permanent"
    return "transient"


class RetryPolicy:
    """Exponential backoff + jitter under a per-gather budget.

    One instance per engine (built from config, see
    :attr:`strom_torch.engine.base.Engine.retry_policy`); per-gather
    state (budget used) lives with the gather, not here — the policy is
    stateless apart from its jitter RNG.
    """

    __slots__ = ("backoff_s", "backoff_max_s", "jitter", "budget", "_rng")

    def __init__(self, *, backoff_s: float = 0.005,
                 backoff_max_s: float = 0.2, jitter: float = 0.25,
                 budget: int = 64, seed: int = 0xC0FFEE):
        self.backoff_s = max(float(backoff_s), 0.0)
        self.backoff_max_s = max(float(backoff_max_s), self.backoff_s)
        self.jitter = max(float(jitter), 0.0)
        self.budget = int(budget)
        self._rng = random.Random(seed)

    @classmethod
    def from_config(cls, config) -> "RetryPolicy":
        return cls(
            backoff_s=getattr(config, "io_retry_backoff_s", 0.005),
            backoff_max_s=getattr(config, "io_retry_backoff_max_s", 0.2),
            budget=getattr(config, "io_retry_budget", 64))

    def delay_s(self, attempts: int) -> float:
        """Backoff before retry number ``attempts + 1`` (attempts = how
        many tries already failed): base * 2^attempts, jittered up to
        ``+jitter`` fraction, capped. Jitter decorrelates a queue-depth's
        worth of simultaneous failures so the resubmits don't land as one
        thundering batch on a device that just choked on exactly that."""
        d = min(self.backoff_s * (2 ** max(attempts, 0)), self.backoff_max_s)
        if self.jitter:
            d *= 1.0 + self.jitter * self._rng.random()
        return d

    def should_retry(self, err: int, attempts: int, retries: int,
                     budget_used: int) -> bool:
        """Whether a failed piece (positive errno *err*, *attempts* tries
        done) earns a resubmit under the per-piece cap AND the per-gather
        budget. Deadline checks are the caller's (it owns the clock)."""
        if attempts >= retries:
            return False
        if budget_used >= self.budget:
            return False
        return classify_errno(err) == "transient"


class CircuitBreaker:
    """Error-rate circuit breaker over a rolling window.

    States (the ``breaker_state`` gauge): 0 = CLOSED (primary path),
    1 = HALF_OPEN (probing), 2 = OPEN (failover). Trips OPEN when the
    window holds >= *min_events* outcomes and the failure fraction is
    >= *error_rate*; after *cooldown_s* the next :meth:`allow` moves to
    HALF_OPEN and lets probes through — *half_open_successes* consecutive
    probe successes close it, any probe failure re-opens (cooldown
    restarts). ``on_trip`` (a hook, the reference's flight-recorder
    dump) fires outside the lock on every CLOSED/HALF_OPEN → OPEN
    transition.
    """

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2

    def __init__(self, *, window_s: float = 10.0, min_events: int = 8,
                 error_rate: float = 0.5, cooldown_s: float = 5.0,
                 half_open_successes: int = 3, scope=None,
                 clock: Callable[[], float] = time.monotonic,
                 on_trip: "Callable[[str], None] | None" = None,
                 name: str = "engine"):
        self.window_s = float(window_s)
        self.min_events = int(min_events)
        self.error_rate = float(error_rate)
        self.cooldown_s = float(cooldown_s)
        self.half_open_successes = int(half_open_successes)
        self.name = name
        self._clock = clock
        self.on_trip = on_trip
        self._scope = scope
        self._lock = make_lock("resil.breaker")
        self._events: deque[tuple[float, bool]] = deque()
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probe_ok = 0
        self.trips = 0
        self.probes = 0
        self.recoveries = 0
        self._gauge(self.CLOSED)

    def _gauge(self, state: int) -> None:
        if self._scope is not None:
            # telemetry must never fail breaker state math
            with contextlib.suppress(Exception):
                self._scope.set_gauge("breaker_state", state)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _prune_locked(self, now: float) -> None:
        lo = now - self.window_s
        ev = self._events
        while ev and ev[0][0] < lo:
            ev.popleft()

    def allow(self) -> bool:
        """True = send this read down the primary path (CLOSED, or a
        HALF_OPEN probe); False = reroute to the fallback (OPEN)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                self._state = self.HALF_OPEN
                self._probe_ok = 0
                self._gauge(self.HALF_OPEN)
            # HALF_OPEN: probe with real traffic
            self.probes += 1
            if self._scope is not None:
                with contextlib.suppress(Exception):
                    self._scope.add("breaker_probes")
            return True

    def record_success(self) -> None:
        with self._lock:
            now = self._clock()
            self._events.append((now, True))
            self._prune_locked(now)
            if self._state == self.HALF_OPEN:
                self._probe_ok += 1
                if self._probe_ok >= self.half_open_successes:
                    self._state = self.CLOSED
                    self._events.clear()  # a fresh start, not stale failures
                    self.recoveries += 1
                    self._gauge(self.CLOSED)
                    if self._scope is not None:
                        with contextlib.suppress(Exception):
                            self._scope.add("breaker_recoveries")

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            now = self._clock()
            self._events.append((now, False))
            self._prune_locked(now)
            if self._state == self.HALF_OPEN:
                # one failed probe re-opens immediately: the engine already
                # proved it isn't back
                self._state = self.OPEN
                self._opened_at = now
                self.trips += 1
                tripped = True
            elif self._state == self.CLOSED:
                fails = sum(1 for _, ok in self._events if not ok)
                if len(self._events) >= self.min_events and \
                        fails / len(self._events) >= self.error_rate:
                    self._state = self.OPEN
                    self._opened_at = now
                    self.trips += 1
                    tripped = True
            if tripped:
                self._gauge(self.OPEN)
        if tripped:
            if self._scope is not None:
                with contextlib.suppress(Exception):
                    self._scope.add("breaker_trips")
            if self.on_trip is not None:
                # the flight-dump hook is advisory: a failed dump must not
                # turn a breaker trip into a read-path crash
                with contextlib.suppress(Exception):
                    self.on_trip(f"circuit breaker '{self.name}' tripped "
                                 f"(trip #{self.trips})")

    def info(self) -> dict:
        with self._lock:
            fails = sum(1 for _, ok in self._events if not ok)
            return {"state": ("closed", "half_open", "open")[self._state],
                    "breaker_state": self._state,
                    "window_events": len(self._events),
                    "window_failures": fails,
                    "breaker_trips": self.trips,
                    "breaker_probes": self.probes,
                    "breaker_recoveries": self.recoveries}


class HedgeController:
    """Adaptive hedge threshold from a rolling completion-cadence window.

    ``observe`` feeds INTER-COMPLETION gaps (seconds) — under pipelining
    this is completion spacing, not per-op service time, so on a deep
    queue the threshold reads "how long a quiet spell is abnormal for
    this gather", floored at ``min_s`` (the blast radius of a too-eager
    threshold is bounded by the delivery layer: one hedge per chunk,
    in-flight chunks only). ``threshold_s``
    returns ``max(min_s, multiplier * rolling_p99)``. The p99 is
    recomputed lazily every 16th observation — hedging is a per-stall
    decision, not
    a per-completion sort. With fewer than 8 observations the floor
    stands alone: hedging a cold pipeline on no evidence would double
    every first read.
    """

    def __init__(self, *, min_s: float = 0.05, multiplier: float = 3.0,
                 window: int = 128):
        self.min_s = float(min_s)
        self.multiplier = float(multiplier)
        self._window = deque(maxlen=max(int(window), 8))
        self._lock = make_lock("resil.hedge")
        self._n = 0
        self._p99 = 0.0

    def observe(self, lat_s: float) -> None:
        with self._lock:
            self._window.append(float(lat_s))
            self._n += 1
            if self._n % 16 == 0:
                self._recompute_locked()

    def _recompute_locked(self) -> None:
        if len(self._window) < 8:
            self._p99 = 0.0
            return
        s = sorted(self._window)
        self._p99 = s[min(int(len(s) * 0.99), len(s) - 1)]

    def threshold_s(self) -> float:
        with self._lock:
            if self._p99 == 0.0 and len(self._window) >= 8:
                self._recompute_locked()
            return max(self.min_s, self.multiplier * self._p99)
