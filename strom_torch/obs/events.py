"""Bounded, thread-safe event ring (the port's copy of
``strom/obs/events.py``): the timeline half of observability.

Instrumented paths (request spans, scheduler grants, engine slices,
streamed gathers) record spans and instants here:

- **cheap enough to leave on**: one ``perf_counter`` read per edge and a
  tuple stored into a preallocated slot list under a short lock. A span is
  recorded as one complete event at its exit (ts + dur).
- **bounded**: fixed capacity, the oldest event overwritten under
  pressure; ``events_dropped`` counts the overwrites.
- **causal**: every event carries (ts_us, dur_us, tid, category, name,
  args) on one monotonic clock.

The consumers of the ring (Chrome traces, stall attribution, the flight
recorder) are not ported yet; :meth:`EventRing.snapshot` is their input.
"""

from __future__ import annotations

import contextlib
import threading
import time
from strom_torch.utils.locks import make_lock

# instant events use dur_us = -1 so snapshot() can tell them apart without a
# second per-event field; flow events (the Chrome-trace s/t/f arrows that
# connect one request's spans across threads) ride the same slot
# with their own sentinels, keeping the hot tuple shape unchanged
_INSTANT = -1.0
_FLOW = {"s": -2.0, "t": -3.0, "f": -4.0}
_FLOW_PH = {v: k for k, v in _FLOW.items()}


class EventRing:
    """Fixed-capacity ring of (ts_us, dur_us, tid, cat, name, args) tuples.

    One module-level instance (:data:`ring`) is shared process-wide, as
    ``strom_torch.utils.stats.global_stats`` is: instrumentation sites
    write unconditionally and tools snapshot when asked.
    """

    def __init__(self, capacity: int = 1 << 16, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._cap = capacity
        self._slots: list[tuple | None] = [None] * capacity
        self._idx = 0          # total events ever written (monotonic)
        self._dropped = 0      # events overwritten after the first wrap
        self._lock = make_lock("ring.events")
        self._t0 = time.perf_counter()
        self.enabled = enabled

    # -- clock --------------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since ring creation (the trace's time base)."""
        return (time.perf_counter() - self._t0) * 1e6

    # -- emission -----------------------------------------------------------
    def _append(self, ev: tuple) -> None:
        with self._lock:
            i = self._idx
            if self._slots[i % self._cap] is not None:
                self._dropped += 1
            self._slots[i % self._cap] = ev
            self._idx = i + 1

    def complete(self, ts_us: float, dur_us: float, cat: str, name: str,
                 args: dict | None = None) -> None:
        """Record a finished span (chrome 'X' event)."""
        if not self.enabled:
            return
        self._append((ts_us, dur_us, threading.get_ident(), cat, name, args))

    def instant(self, name: str, cat: str = "",
                args: dict | None = None) -> None:
        """Record a point event (chrome 'i' event)."""
        if not self.enabled:
            return
        self._append((self.now_us(), _INSTANT, threading.get_ident(), cat,
                      name, args))

    def flow(self, phase: str, flow_id: int, name: str,
             cat: str = "") -> None:
        """Record a flow event (chrome 's'/'t'/'f'): consecutive events of
        one *flow_id* render as arrows connecting the spans that enclose
        them — the per-request causal chain (obs/request.py)."""
        if not self.enabled:
            return
        self._append((self.now_us(), _FLOW[phase], threading.get_ident(),
                      cat, name, {"id": int(flow_id)}))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", args: dict | None = None):
        """Record the with-block as one complete event (recorded even when
        the block raises — a failed gather is exactly the span you want on
        the timeline)."""
        if not self.enabled:
            yield
            return
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(t0, self.now_us() - t0, cat, name, args)

    # -- inspection ---------------------------------------------------------
    @property
    def events_dropped(self) -> int:
        with self._lock:
            return self._dropped

    @property
    def events_written(self) -> int:
        """Total events ever recorded (monotonic, survives wraps): the
        flight recorder's ring-pressure signal — a delta between two
        samples is the event rate, where ``len(ring)`` saturates at
        capacity the moment the ring wraps."""
        with self._lock:
            return self._idx

    @property
    def high_water(self) -> int:
        """Max retained occupancy so far (== capacity once wrapped): how
        close the ring has come to dropping history."""
        with self._lock:
            return min(self._idx, self._cap)

    @property
    def capacity(self) -> int:
        return self._cap

    def __len__(self) -> int:
        with self._lock:
            return min(self._idx, self._cap)

    def snapshot(self, since_us: float | None = None) -> list[dict]:
        """The retained events as dicts, oldest first (ts-sorted within the
        retained window). The lock is held only for a C-level list copy —
        a scrape of a full ring must not stall every hot-path writer for
        the duration of 64Ki dict constructions. *since_us* keeps only the
        events that end at or after it, dropped before any dict is built
        (a context's step summary over a full ring of older events)."""
        with self._lock:
            slots = list(self._slots)
            idx = self._idx
            dropped = self._dropped
        n = min(idx, self._cap)
        evs = [slots[i % self._cap] for i in range(idx - n, idx)]
        out = []
        for ev in evs:
            if ev is None:  # cleared ring / not yet wrapped
                continue
            ts, dur, tid, cat, name, args = ev
            if since_us is not None and (ts + dur if dur >= 0 else ts) \
                    < since_us:
                continue
            if dur in _FLOW_PH:
                d = {"ts_us": ts, "tid": tid, "cat": cat, "name": name,
                     "ph": _FLOW_PH[dur],
                     "id": (args or {}).get("id", 0)}
                out.append(d)
                continue
            d = {"ts_us": ts, "tid": tid, "cat": cat, "name": name,
                 "ph": "i" if dur == _INSTANT else "X"}
            if dur != _INSTANT:
                d["dur_us"] = dur
            if args:
                d["args"] = args
            out.append(d)
        # completion order == exit order for spans; sort by START time so
        # consumers see a timeline (nested spans exit before their parents)
        out.sort(key=lambda e: e["ts_us"])
        if dropped:
            out.insert(0, {"ts_us": out[0]["ts_us"] if out else 0.0,
                           "tid": 0, "cat": "meta", "name": "events_dropped",
                           "ph": "i", "args": {"count": dropped}})
        return out

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self._cap
            self._idx = 0
            self._dropped = 0


# the process-wide ring every instrumentation site writes to
ring = EventRing()
