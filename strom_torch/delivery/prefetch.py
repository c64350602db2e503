"""Prefetch queue: keep N batches in flight so compute never waits on I/O
(the port's copy of ``strom/delivery/prefetch.py``).

The "0 data-stall steps" counter lives here: a stall is recorded whenever
``next()`` has to block because the head-of-line batch isn't ready.

Depth is hand-picked (``depth=``) or auto-tuned (``auto_depth=True``): the
controller GROWS depth multiplicatively on a stall (the dispatch-ahead
window was too shallow for the observed jitter) and SHRINKS it by one once
the queue has run fully ready for a patience window (the extra in-flight
batches only pin slab-pool memory). Depth stays inside [min_depth,
max_depth]; callers bound max_depth by slab-pool capacity
(:func:`bound_depth`).

The counts live on the Prefetcher itself (:meth:`Prefetcher.snapshot`,
``depth_trace``); the depth and the stall count are also mirrored as the
gauges ``prefetch_depth`` and ``prefetch_data_stall_steps`` into a
telemetry scope (the pipeline's), so they reach ``/metrics``.
"""

from __future__ import annotations

import concurrent.futures
import time
from collections import deque
from typing import Callable, Generic, Iterable, Iterator, TypeVar

from strom_torch.obs.events import ring as _events_ring
from strom_torch.utils.locks import make_lock
from strom_torch.utils.stats import StatsRegistry, global_stats

T = TypeVar("T")

# grow is multiplicative (a stall under-estimates the needed window by an
# unknown factor; doubling finds it in log steps), shrink is one step per
# patience window of fully-ready pops: depth converges from above without
# oscillating into stalls
_SHRINK_PATIENCE = 8
_TRACE_CAP = 512


def bound_depth(pool_bytes: int, batch_bytes: int, *, floor: int = 2,
                cap: int = 32, reserve_bytes: int = 0) -> int:
    """Max prefetch depth a slab pool of *pool_bytes* can stage when each
    in-flight batch owns ~*batch_bytes* of slabs until its copy retires.
    Unknown sizes (<=0) fall back to *cap*.

    *reserve_bytes* is capacity spoken for by someone else: the hot cache's
    ``hot_cache_bytes`` budget (strom_torch/delivery/hotcache.py), so
    depth growth and cache admission never commit the same memory twice.
    A reserve at or beyond the pool collapses depth to *floor*."""
    if pool_bytes <= 0 or batch_bytes <= 0:
        return cap
    avail = pool_bytes - max(reserve_bytes, 0)
    if avail <= 0:
        return floor
    return max(floor, min(cap, avail // batch_bytes))


class Prefetcher(Generic[T]):
    """Wraps an iterable of thunks (callables producing a batch) and runs
    up to *depth* of them ahead on an executor, yielding results in order.

    Thunks end in the host→device copy being enqueued, so "ready" means the
    host-side work is done and the copy is ordered before the consumer's
    next kernel.

    With ``auto_depth=True``, *depth* is the starting point and the
    controller moves it inside [min_depth, max_depth]. ``depth_trace``
    records every change as (step, new_depth).

    *scope*: the telemetry scope the depth and stall gauges are mirrored
    into (a pipeline's label scope: the scoped series and the aggregate);
    None is the process-wide registry. Gauges hold the current state, so
    within one scope the latest prefetcher wins."""

    def __init__(self, thunks: Iterable[Callable[[], T]], *, depth: int = 2,
                 executor: concurrent.futures.Executor | None = None,
                 auto_depth: bool = False,
                 min_depth: int = 1,
                 max_depth: int | None = None,
                 scope=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if min_depth < 1:
            raise ValueError("min_depth must be >= 1")
        self._auto = auto_depth
        if max_depth is None:
            max_depth = max(depth, 16) if auto_depth else depth
        if max_depth < min_depth:
            raise ValueError(f"max_depth {max_depth} < min_depth {min_depth}")
        self._min_depth = min_depth
        self._max_depth = max_depth
        self._depth = min(max(depth, min_depth), max_depth)
        self._thunks = iter(thunks)
        self._own_executor = executor is None
        # auto mode sizes its own pool at the ceiling, so a grown depth has
        # workers to run the extra thunks
        self._executor = executor or concurrent.futures.ThreadPoolExecutor(
            max_workers=max_depth if auto_depth else depth,
            thread_name_prefix="strom-prefetch")
        self._queue: deque[concurrent.futures.Future] = deque()
        self._lock = make_lock("app.prefetch")
        # steps, data_stall_steps, depth_grow, depth_shrink, and lead_count
        # (pops that found the head ready) with their lead_us_total, in a
        # registry of the prefetcher's own (all_counter_names sees it)
        self.stats = StatsRegistry("prefetch")
        self.stats.set_gauge("prefetch_depth", self._depth)
        self._scope = scope if scope is not None else global_stats
        self._scope.set_gauge("prefetch_depth", self._depth)
        self._scope.set_gauge("prefetch_data_stall_steps", 0)
        self.depth_trace: list[tuple[int, int]] = [(0, self._depth)]
        self._ready_streak = 0
        self._exhausted = False
        self._fill()

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def data_stall_steps(self) -> int:
        return self.stats.counter("data_stall_steps").value

    @property
    def steps(self) -> int:
        return self.stats.counter("steps").value

    def snapshot(self) -> dict:
        """The counters and the current depth (``prefetch_depth``)."""
        out = {k: self.stats.counter(k).value
               for k in self.stats.counter_names()}
        out["prefetch_depth"] = self._depth
        return out

    def set_depth(self, depth: int) -> None:
        """Move the target depth inside [min_depth, max_depth] from outside
        the controller. A hand-depth pool also caps at its worker count (a
        deeper queue than workers would only park thunks)."""
        cap = self._max_depth if self._auto \
            else min(self._max_depth, self._executor._max_workers)
        d = min(max(int(depth), self._min_depth), cap)
        self._set_depth(d, "grow" if d > self._depth else "shrink")

    def _fill(self) -> None:
        # next(thunks) runs outside the lock: a thunk generator may block
        while True:
            with self._lock:
                if len(self._queue) >= self._depth or self._exhausted:
                    return
            try:
                thunk = next(self._thunks)
            except StopIteration:
                with self._lock:
                    self._exhausted = True
                return
            with self._lock:
                if self._exhausted:  # close() raced the pull: drop, don't submit
                    return
                fut = self._executor.submit(thunk)
                fut.add_done_callback(_stamp_done)
                self._queue.append(fut)

    def _set_depth(self, depth: int, kind: str) -> None:
        """Record a controller move (single consumer, like the class)."""
        if depth == self._depth:
            return
        self._depth = depth
        self.stats.add("depth_grow" if kind == "grow" else "depth_shrink")
        self.stats.set_gauge("prefetch_depth", depth)
        self._scope.set_gauge("prefetch_depth", depth)
        if len(self.depth_trace) < _TRACE_CAP:
            self.depth_trace.append((self.steps, depth))

    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        with self._lock:
            fut = self._queue.popleft() if self._queue else None
            exhausted = self._exhausted
        if fut is None:
            if exhausted:
                self._shutdown()
                raise StopIteration
            self._fill()   # nothing queued yet: refill and retry
            with self._lock:
                if not self._queue:
                    self._shutdown()
                    raise StopIteration
                fut = self._queue.popleft()
        if not fut.done():
            self.stats.add("data_stall_steps")
            self._scope.set_gauge("prefetch_data_stall_steps",
                                  self.data_stall_steps)
            with _events_ring.span("prefetch.stall_wait", cat="ingest_wait"):
                result = fut.result()
            if self._auto:
                # a stall: the window was too shallow for the jitter
                self._ready_streak = 0
                self._set_depth(min(self._depth * 2, self._max_depth), "grow")
        else:
            result = fut.result()
            done_at = getattr(fut, "_strom_done_at", None)
            if done_at is not None:
                # lead time: how long the head batch sat ready before the
                # consumer came for it
                self.stats.add("lead_count")
                self.stats.add("lead_us_total", int(
                    max(time.monotonic() - done_at, 0.0) * 1e6))
            if self._auto:
                with self._lock:
                    full_ready = (len(self._queue) + 1 >= self._depth
                                  and all(f.done() for f in self._queue))
                if full_ready:
                    self._ready_streak += 1
                    if (self._ready_streak >= _SHRINK_PATIENCE
                            and self._depth > self._min_depth):
                        self._set_depth(self._depth - 1, "shrink")
                        self._ready_streak = 0
                else:
                    self._ready_streak = 0
        self.stats.add("steps")
        self._fill()
        return result

    def _shutdown(self) -> None:
        if self._own_executor:
            self._executor.shutdown(wait=False)

    def close(self) -> None:
        with self._lock:
            live = [f for f in self._queue if not f.cancel()]
            self._queue.clear()
            self._exhausted = True
        # a thunk already running keeps using the engine the pipeline tears
        # down after this returns: give it a bounded window to retire
        if live:
            concurrent.futures.wait(live, timeout=30.0)
        self._shutdown()


def _stamp_done(fut: concurrent.futures.Future) -> None:
    fut._strom_done_at = time.monotonic()  # type: ignore[attr-defined]
