"""Per-tenant budgets and slab-pool admission control (the port's copy of
``strom/sched/budget.py``).

- :class:`TokenBucket` limits one axis (bytes/s, IOPS). The scheduler
  *peeks* a bucket while it picks the next grant (a throttled tenant is
  skipped, its ready time bounding the retry wait) and *takes* only for
  the grant it issues. An op larger than the burst drives the balance
  negative, and later ops wait out the debt, so the long-run rate holds
  for any op size.
- :class:`AdmissionGate` queues background-class allocations (the
  readahead's warm buffers) while the slab pool sits above its high-water
  mark; demand classes are never gated.

Both take an injectable clock, so the fairness tests run deterministically.
"""

from __future__ import annotations

import time
from typing import Callable
from strom_torch.utils.locks import make_condition, make_lock


class TokenBucket:
    """Token bucket over any unit (bytes, ops): ``rate`` units a second,
    ``burst`` units of capacity. ``rate <= 0`` is unlimited."""

    def __init__(self, rate: float, burst: float | None = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        # default burst: one second's worth
        self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
        self._clock = clock
        self._tokens = self.burst
        self._t = clock()
        self._lock = make_lock("budget.bucket")

    @property
    def unlimited(self) -> bool:
        return self.rate <= 0

    def _refill_locked(self) -> None:
        now = self._clock()
        if now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = now

    def peek(self, n: float) -> float:
        """Seconds until *n* units could be taken (0.0 = now); consumes
        nothing. An op above the burst is ready once the balance is not
        negative."""
        if self.unlimited or n <= 0:
            return 0.0
        with self._lock:
            self._refill_locked()
            need = min(float(n), self.burst)
            if self._tokens >= need:
                return 0.0
            return (need - self._tokens) / self.rate

    def take(self, n: float) -> None:
        """Charge *n* units, possibly into debt."""
        if self.unlimited or n <= 0:
            return
        with self._lock:
            self._refill_locked()
            self._tokens -= float(n)

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens

    def state(self) -> dict:
        return {"rate": self.rate, "burst": self.burst,
                "tokens": round(self.tokens, 1),
                "unlimited": self.unlimited}


class AdmissionGate:
    """Slab-pool high-water admission for opportunistic allocations.

    ``admit(nbytes)`` returns at once while the pool's bytes in use plus the
    request stay at or under ``high_water * pool.max_bytes``; above it the
    caller waits on a condition the pool's change hook notifies (one
    ``slab_pool_admission_waits`` a wait). A pool of None, or
    ``high_water <= 0``, disables the gate."""

    def __init__(self, pool, high_water: float = 0.9, *, scope=None,
                 clock: Callable[[], float] = time.monotonic):
        from strom_torch.utils.stats import global_stats

        self._pool = pool
        self.high_water = float(high_water)
        self._scope = scope if scope is not None else global_stats
        self._clock = clock
        self._cond = make_condition("sched.admission")
        self.waits = 0
        if pool is not None:
            pool.add_change_hook(self._on_pool_change)

    @property
    def enabled(self) -> bool:
        return self._pool is not None and self.high_water > 0

    def _limit(self) -> int:
        return int(self.high_water * self._pool.max_bytes)

    def has_room(self, nbytes: int) -> bool:
        if not self.enabled:
            return True
        return self._pool.in_use_bytes + max(int(nbytes), 0) <= self._limit()

    def _on_pool_change(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def admit(self, nbytes: int, *, timeout_s: float | None = None) -> bool:
        """Block until *nbytes* of headroom exists below the high-water mark
        (True) or *timeout_s* elapses (False). A request larger than the
        whole budget is admitted once the pool is otherwise idle."""
        if self.has_room(nbytes):
            return True
        deadline = None if timeout_s is None else self._clock() + timeout_s
        self.waits += 1
        self._scope.add("slab_pool_admission_waits")
        with self._cond:
            while True:
                if self.has_room(nbytes) or \
                        self._pool.in_use_bytes == 0:
                    return True
                wait = 0.05 if deadline is None \
                    else min(0.05, deadline - self._clock())
                if wait <= 0:
                    return False
                self._cond.wait(wait)

    def state(self) -> dict:
        if not self.enabled:
            return {"enabled": False, "waits": self.waits}
        return {"enabled": True, "high_water": self.high_water,
                "limit_bytes": self._limit(),
                "in_use_bytes": self._pool.in_use_bytes,
                "waits": self.waits}
