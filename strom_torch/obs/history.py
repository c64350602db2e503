"""Snapshot history: an in-process time series, no external TSDB (the
port's copy of ``strom/obs/history.py``).

A scrape sees lifetime counters and must keep its own previous sample to
compute a rate. :class:`StatsHistory` keeps a bounded ring of periodic
flat snapshots instead, so the live server's ``/history`` route serves
``rate()``-able series and a post-mortem has the last minutes of counter
movement even when nothing was scraping.

Each sample is the process-wide registry snapshot (histogram bucket lists
dropped) plus the per-scope snapshots, stamped with a monotonic ``ts_s``.
A tick costs one registry snapshot: the context's expensive sections
(stall attribution) are not sampled, and nothing here touches the device.
"""

from __future__ import annotations

import threading
import time

from strom_torch.utils.locks import make_lock

# keys every sample carries beyond the registry's
HISTORY_META_KEYS = ("ts_s",)


def _flatten(snap: dict) -> dict:
    """Numeric leaves only: bucket lists are no trend data."""
    return {k: v for k, v in snap.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


class StatsHistory:
    """Bounded ring of periodic flat stats samples, and rate math."""

    def __init__(self, *, interval_s: float = 2.0, capacity: int = 300,
                 clock=time.monotonic, start: bool = True):
        self.interval_s = max(float(interval_s), 0.05)
        self.capacity = max(int(capacity), 2)
        self._clock = clock
        self._t0 = clock()
        self._lock = make_lock("obs.history")
        self._samples: list[dict] = []
        # failed ticks, counted: a broken sampler must stay distinguishable
        # from "nothing changed"
        self.sample_errors = 0
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(target=self._run,
                                            name="strom-history",
                                            daemon=True)
            self._thread.start()

    # -- sampling ------------------------------------------------------------
    def sample(self) -> dict:
        """Take (and keep) one sample now; returns it."""
        from strom_torch.utils.stats import global_stats

        s = {"ts_s": round(self._clock() - self._t0, 3)}
        s.update(_flatten(global_stats.snapshot()))
        scopes = {}
        for lbl, snap in global_stats.scopes_snapshot().items():
            flat = _flatten(snap)
            if flat:
                scopes[lbl] = flat
        if scopes:
            s["scopes"] = scopes
        with self._lock:
            self._samples.append(s)
            if len(self._samples) > self.capacity:
                del self._samples[: len(self._samples) - self.capacity]
        return s

    def _run(self) -> None:
        while not self._closed.wait(self.interval_s):
            try:
                self.sample()
            except Exception:
                # a failed tick never kills the sampler; it is counted and
                # shown in the /history body
                self.sample_errors += 1

    # -- reads ---------------------------------------------------------------
    def samples(self, since_s: "float | None" = None,
                keys: "list[str] | None" = None) -> list[dict]:
        with self._lock:
            out = list(self._samples)
        if since_s is not None:
            out = [s for s in out if s["ts_s"] >= since_s]
        if keys is not None:
            want = set(keys) | set(HISTORY_META_KEYS)
            out = [{k: v for k, v in s.items() if k in want} for s in out]
        return out

    def snapshot(self, since_s: "float | None" = None,
                 keys: "list[str] | None" = None) -> dict:
        """The ``/history`` route body."""
        return {"interval_s": self.interval_s,
                "capacity": self.capacity,
                "sample_errors": self.sample_errors,
                "samples": self.samples(since_s, keys)}

    def rate(self, key: str, window_s: "float | None" = None,
             scope: "str | None" = None) -> "float | None":
        """Per-second growth of counter *key* over the last *window_s*
        (default: the whole ring). *scope* picks a labelled series by its
        label string (``tenant="t0"``). None when fewer than two samples
        cover the window: "unknown" stays distinct from "zero"."""
        with self._lock:
            samples = list(self._samples)
        if window_s is not None and samples:
            lo = samples[-1]["ts_s"] - window_s
            samples = [s for s in samples if s["ts_s"] >= lo]

        def val(s: dict):
            src = s.get("scopes", {}).get(scope) if scope else s
            return None if src is None else src.get(key)

        pts = [(s["ts_s"], val(s)) for s in samples]
        pts = [(t, v) for t, v in pts if v is not None]
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
