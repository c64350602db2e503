"""Tenant handles for the shared I/O scheduler (the port's copy of
``strom/sched/tenant.py``).

A :class:`Tenant` is one consumer of the shared engine: a pipeline, a scan
or the readahead thread. It carries a priority class (``interactive`` >
``training`` > ``background``, strict between classes, weighted fair
within one), a telemetry scope (``tenant=<name>`` over the context's
scope), optional byte/s and IOPS budgets, and an optional hot-cache
partition. Queue state is owned by the scheduler and mutated only under
its lock.
"""

from __future__ import annotations

from collections import deque
from typing import Any

from strom_torch.sched.budget import TokenBucket

# strict-priority classes, drained in this order; readahead and spill I/O
# always run as "background"
PRIORITIES = ("interactive", "training", "background")
PRIORITY_ORDER = {name: i for i, name in enumerate(PRIORITIES)}


class Tenant:
    """One registered consumer of the shared engine."""

    def __init__(self, name: str, *, priority: str = "training",
                 weight: int = 1, scope: Any = None,
                 byte_rate: float = 0, byte_burst: float | None = None,
                 iops: float = 0, hot_cache_bytes: int = 0,
                 clock=None):
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        if weight < 1:
            raise ValueError(f"weight must be >= 1, got {weight}")
        from strom_torch.utils.stats import global_stats

        self.name = name
        self.priority = priority
        self.weight = int(weight)
        self.scope = scope if scope is not None else global_stats
        kw = {} if clock is None else {"clock": clock}
        self.byte_bucket = TokenBucket(byte_rate, byte_burst, **kw)
        self.iops_bucket = TokenBucket(iops, **kw)
        self.hot_cache_bytes = int(hot_cache_bytes)
        # scheduler-owned state (mutated under the scheduler's lock)
        self.queue: deque = deque()          # queued waiters, FIFO
        self.queued_bytes = 0
        self.active = 0                      # grants currently held
        self.vtime = 0.0                     # weighted service received
        self.granted_ops = 0
        self.granted_bytes = 0
        self.throttle_waits = 0

    def info(self) -> dict:
        return {
            "name": self.name,
            "priority": self.priority,
            "weight": self.weight,
            "queued_ops": len(self.queue),
            "queued_bytes": self.queued_bytes,
            "active_grants": self.active,
            "granted_ops": self.granted_ops,
            "granted_bytes": self.granted_bytes,
            "throttle_waits": self.throttle_waits,
            "byte_budget": self.byte_bucket.state(),
            "iops_budget": self.iops_bucket.state(),
            "hot_cache_bytes": self.hot_cache_bytes,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Tenant({self.name!r}, priority={self.priority!r}, "
                f"weight={self.weight}, queued={len(self.queue)})")
