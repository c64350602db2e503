"""Always-on flight recorder (the port's copy of ``strom/obs/flight.py``):
post-mortem observability for wedged runs.

The counters answer "what did the run do overall?"; this answers *what was
the process doing when it died or stalled?* It is sized to stay on:

- A **watchdog thread** samples cheap progress signals (pipeline step
  counters, delivered bytes, slab-pool occupancy, engine in-flight depth,
  event-ring high-water marks) into a small bounded ring — one
  ``FLIGHT_FIELDS`` dict per tick.
- On **SIGTERM**, an **unhandled exception**, or **no step progress for
  longer than ``flight_stall_s``**, it dumps an atomic crash bundle: the
  Chrome trace of the event ring, a full stats snapshot (scopes included),
  per-thread Python stacks (``sys._current_frames``), the last-N flight
  samples and the exemplar store. The bundle is written to a temp dir and
  ``os.rename``d into place, so a half-written bundle never passes for a
  whole one.

The watchdog tells *slow but advancing* from *wedged* by COUNTER DELTAS,
not wall time per step: any progress within the stall window resets the
clock, so a slow step loop never trips it.

Wired as ``StromConfig.flight_dir`` / ``flight_stall_s``
(``STROM_FLIGHT_DIR`` / ``STROM_FLIGHT_STALL_S``) and ``StromContext``
construction (a context with a flight_dir runs its recorder for the
context's lifetime). The port's delivered-bytes counter is
``ssd2gpu_bytes`` where the reference's is ``ssd2tpu_bytes``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import signal
import socket
import sys
import threading
import time
import traceback
from typing import Callable

from strom_torch.obs.events import EventRing, ring as _global_ring
from strom_torch.utils.locks import make_lock

# one flight sample per watchdog tick, single-sourced (the lint and the
# bundle loader read this tuple, same contract as STALL_FIELDS /
# CACHE_BENCH_FIELDS): progress counters first, pressure gauges after
FLIGHT_FIELDS = (
    "ts_s",                 # monotonic seconds since recorder start
    "pipeline_steps",       # global step counter (Pipeline.__next__)
    "ssd2gpu_bytes",        # delivered bytes (progress for non-pipeline runs)
    "slab_in_use_bytes",    # slab-pool occupancy (memory pressure)
    "engine_inflight",      # engine queue occupancy at the sample instant
    "ring_events_written",  # event-ring total writes (activity rate)
    "ring_events_dropped",  # event-ring overwrites (history loss)
    "exemplars_retained",   # tail-sampled slow/throttled/errored request
                            # trees held by the exemplar store —
                            # a climbing delta during a stall episode says
                            # the slowness is requests, not the consumer
)

# bundle members (atomic dir contents); flight.json is the manifest
BUNDLE_MANIFEST = "flight.json"
BUNDLE_TRACE = "trace.json"
BUNDLE_STATS = "stats.json"
BUNDLE_STACKS = "stacks.txt"
BUNDLE_EXEMPLARS = "exemplars.json"


def thread_stacks() -> str:
    """Every Python thread's current stack, flight-recorder style (the
    pure-Python twin of ``faulthandler.dump_traceback``, kept in-process so
    it can land inside an atomic bundle instead of on stderr)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def load_bundle(path: str) -> dict:
    """Load a dumped bundle back: {'manifest': ..., 'trace': ...,
    'stats': ..., 'stacks': str}. The round-trip the tests assert — a
    bundle a human can't load is a black box in the bad sense."""
    out: dict = {}
    with open(os.path.join(path, BUNDLE_MANIFEST)) as f:
        out["manifest"] = json.load(f)
    with open(os.path.join(path, BUNDLE_TRACE)) as f:
        out["trace"] = json.load(f)
    with open(os.path.join(path, BUNDLE_STATS)) as f:
        out["stats"] = json.load(f)
    with open(os.path.join(path, BUNDLE_STACKS)) as f:
        out["stacks"] = f.read()
    # bundles without exemplars (the reference's older format) still load
    exp = os.path.join(path, BUNDLE_EXEMPLARS)
    if os.path.exists(exp):
        with open(exp) as f:
            out["exemplars"] = json.load(f)
    return out


def capture_doc(*, ctx=None, ring: EventRing | None = None,
                reason: str = "on_demand", note: str = "") -> dict:
    """One point-in-time capture document (no recorder needed): stats
    snapshot (scopes included), per-thread stacks, event-ring trace. The
    /flight route serves this even when no FlightRecorder is configured;
    :meth:`FlightRecorder.capture` layers its sample history on top."""
    from strom_torch.obs.chrome_trace import trace_document
    from strom_torch.obs.exemplars import store as _exemplars
    from strom_torch.utils.stats import global_stats

    ring = ring or _global_ring
    stats: dict = {"global": global_stats.snapshot(),
                   "scopes": global_stats.scopes_snapshot()}
    if ctx is not None:
        with contextlib.suppress(Exception):
            stats["sections"] = ctx.stats()
    # every bundle names the host that wrote it; the peer fabric's
    # addresses join once the port has one (the key stays, empty)
    peer_addrs: list = []
    return {
        "reason": reason,
        "note": note,
        "pid": os.getpid(),
        "host": f"{socket.gethostname()}:{os.getpid()}",
        "peer_addrs": peer_addrs,
        "fields": list(FLIGHT_FIELDS),
        "samples": [],
        "stall_s": 0.0,
        "interval_s": 0.0,
        "stats": stats,
        "stacks": thread_stacks(),
        "trace": trace_document(ring.snapshot()),
        # the tail-sampled span trees: a crash/stall bundle carries the
        # slowest recent requests, whole
        "exemplars": _exemplars.snapshot(),
    }


def _write_bundle(flight_dir: str, cap: dict, reason: str,
                  serial: int) -> str:
    """Write one capture document as an atomic bundle dir under
    *flight_dir* and return its path. Contents land in a ``.tmp-`` dir
    first and rename into place LAST, so readers never see a partial
    bundle. Shared by :meth:`FlightRecorder.dump` and the recorder-less
    :func:`dump_capture` (the lock-order witness's cycle dump)."""
    name = f"flight-{os.getpid()}-{reason}-{serial:03d}"
    final = os.path.join(flight_dir, name)
    tmp = os.path.join(flight_dir, f".tmp-{name}")
    os.makedirs(tmp, exist_ok=True)
    # .get: captures from before the host/peer stamps (or a recorder's
    # layered doc built without them) still dump — stable-format contract
    manifest = {k: cap.get(k) for k in
                ("reason", "note", "pid", "host", "peer_addrs", "fields",
                 "samples", "stall_s", "interval_s")}
    with open(os.path.join(tmp, BUNDLE_MANIFEST), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, BUNDLE_TRACE), "w") as f:
        json.dump(cap["trace"], f)
    with open(os.path.join(tmp, BUNDLE_STATS), "w") as f:
        json.dump(cap["stats"], f, default=str)
    with open(os.path.join(tmp, BUNDLE_STACKS), "w") as f:
        f.write(cap["stacks"])
    with open(os.path.join(tmp, BUNDLE_EXEMPLARS), "w") as f:
        json.dump(cap.get("exemplars", {}), f, default=str)
    if os.path.isdir(final):  # a previous half-life of this serial
        final = final + f"-{int(time.time())}"
    os.rename(tmp, final)
    return final


# thread-safe ad-hoc serial: two simultaneous dumps (e.g. two threads
# tripping the lock witness at once) must not share a bundle dir
_adhoc_serial = itertools.count(1)


def dump_capture(flight_dir: str, *, reason: str = "on_demand",
                 note: str = "", ctx=None) -> str:
    """One-shot bundle dump with no recorder: a point-in-time
    :func:`capture_doc` written atomically under *flight_dir*. The
    lock-order witness (:mod:`strom_torch.utils.locks`) dumps through this when a
    cycle is detected, so the inversion arrives with stacks, stats and
    the event-ring trace attached."""
    os.makedirs(flight_dir, exist_ok=True)
    return _write_bundle(flight_dir, capture_doc(ctx=ctx, reason=reason,
                                                 note=note),
                         reason, next(_adhoc_serial))


class FlightRecorder:
    """Watchdog + sample ring + crash-bundle dumper.

    *ctx* (a ``StromContext``) supplies slab/engine occupancy and the full
    stats snapshot when given; without it the recorder still samples the
    global registry and event ring.
    *stall_s* <= 0 disables the no-progress trigger (sampling, signal and
    exception dumps stay armed). Signal/excepthook installation chains the
    previous handlers and is skipped off the main thread.
    """

    def __init__(self, flight_dir: str, *, ctx=None,
                 stall_s: float = 0.0, interval_s: float = 0.5,
                 max_samples: int = 240, ring: EventRing | None = None,
                 install_signal: bool = True,
                 install_excepthook: bool = True,
                 progress_fn: Callable[[], float] | None = None):
        self.flight_dir = flight_dir
        self._ctx = ctx
        self._ring = ring or _global_ring
        self.stall_s = float(stall_s)
        self.interval_s = max(float(interval_s), 0.01)
        self._samples: list[dict] = []
        self._max_samples = max(int(max_samples), 8)
        self._lock = make_lock("obs.flight")
        self._t0 = time.monotonic()
        self._progress_fn = progress_fn or self._default_progress
        self._last_progress_val: float | None = None
        self._last_progress_t = time.monotonic()
        self._stall_dumped = False
        self._dumps = 0
        self._closed = threading.Event()
        self._prev_sigterm = None
        self._prev_excepthook = None
        os.makedirs(flight_dir, exist_ok=True)
        if install_signal:
            self._install_sigterm()
        if install_excepthook:
            self._install_excepthook()
        self._thread = threading.Thread(target=self._watch,
                                        name="strom-flight", daemon=True)
        self._thread.start()

    # -- progress + sampling ------------------------------------------------
    def _default_progress(self) -> float:
        """A number that moves whenever the run advances: step count plus
        delivered bytes (covers pipeline loops AND raw delivery phases).
        Any change — not any rate — counts as progress, so slow-but-
        advancing never trips the watchdog."""
        from strom_torch.utils.stats import global_stats

        return (global_stats.counter("pipeline_steps").value
                + global_stats.counter("ssd2gpu_bytes").value)

    def sample(self) -> dict:
        """One FLIGHT_FIELDS sample (also appended by the watchdog tick)."""
        from strom_torch.utils.stats import global_stats

        slab = 0
        inflight = 0
        ctx = self._ctx
        if ctx is not None:
            with contextlib.suppress(Exception):
                pool = getattr(ctx, "_slab_pool", None)
                if pool is not None:
                    slab = int(pool.stats().get("slab_in_use_bytes", 0))
            with contextlib.suppress(Exception):
                inflight = int(ctx.engine.in_flight())
        from strom_torch.obs.exemplars import store as _exemplars

        return {
            "ts_s": round(time.monotonic() - self._t0, 3),
            "pipeline_steps":
                global_stats.counter("pipeline_steps").value,
            "ssd2gpu_bytes": global_stats.counter("ssd2gpu_bytes").value,
            "slab_in_use_bytes": slab,
            "engine_inflight": inflight,
            "ring_events_written": self._ring.events_written,
            "ring_events_dropped": self._ring.events_dropped,
            "exemplars_retained": _exemplars.retained,
        }

    def samples(self) -> list[dict]:
        with self._lock:
            return list(self._samples)

    def _tick(self) -> None:
        s = self.sample()
        with self._lock:
            self._samples.append(s)
            if len(self._samples) > self._max_samples:
                del self._samples[: len(self._samples) - self._max_samples]
        now = time.monotonic()
        try:
            prog = float(self._progress_fn())
        # a failing progress probe skips THIS tick and the next tick retries; counting it
        # through the stats registry could recurse into the very probe
        # that failed (the default probe reads the registry)
        except Exception:
            return
        if self._last_progress_val is None or prog != self._last_progress_val:
            self._last_progress_val = prog
            self._last_progress_t = now
            self._stall_dumped = False  # new episode after recovery
            return
        if (self.stall_s > 0 and not self._stall_dumped
                and now - self._last_progress_t > self.stall_s):
            # one dump per stall episode: a wedged run must not fill the
            # disk with one bundle per tick while it stays wedged
            self._stall_dumped = True
            with contextlib.suppress(Exception):
                self.dump("stall")

    def _watch(self) -> None:
        while not self._closed.wait(self.interval_s):
            with contextlib.suppress(Exception):
                self._tick()

    # -- triggers -----------------------------------------------------------
    def _install_sigterm(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                with contextlib.suppress(Exception):
                    self.dump("sigterm")
                if prev is signal.SIG_IGN:
                    # the process deliberately ignores SIGTERM (e.g. a
                    # critical flush window): dump the bundle, keep
                    # ignoring — arming a recorder must not turn an
                    # ignored signal into process death
                    return
                if callable(prev):
                    prev(signum, frame)
                else:
                    # restore + re-raise so the exit status still says
                    # "killed by SIGTERM" to the parent
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    signal.raise_signal(signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_term)
            self._prev_sigterm = prev
            self._installed_sigterm = on_term
        except (ValueError, OSError):  # non-main thread / exotic platform
            pass

    def _install_excepthook(self) -> None:
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            with contextlib.suppress(Exception):
                self.dump("exception", note="".join(
                    traceback.format_exception_only(exc_type, exc)).strip())
            prev(exc_type, exc, tb)

        sys.excepthook = hook
        self._prev_excepthook = prev
        self._installed_excepthook = hook

    # -- capture ------------------------------------------------------------
    def capture(self, reason: str = "on_demand", note: str = "") -> dict:
        """The bundle as one in-memory dict (the /flight route body): same
        content as a dumped bundle, no filesystem involved."""
        doc = capture_doc(ctx=self._ctx, ring=self._ring, reason=reason,
                          note=note)
        doc["samples"] = self.samples() + [self.sample()]
        doc["stall_s"] = self.stall_s
        doc["interval_s"] = self.interval_s
        return doc

    def dump(self, reason: str, note: str = "") -> str:
        """Write an atomic crash bundle under ``flight_dir`` and return its
        path. Bundle dir name carries pid + reason + a serial (several
        dumps per process must not clobber each other); contents land in a
        ``.tmp-`` dir first and rename into place LAST, so readers never
        see a partial bundle."""
        cap = self.capture(reason, note)
        with self._lock:
            self._dumps += 1
            serial = self._dumps
        return _write_bundle(self.flight_dir, cap, reason, serial)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=5)
        # restore chained hooks ONLY where OUR hook is still the installed
        # one (identity check): a later-created recorder may have chained
        # on top of us, and restoring over it would silently disarm its
        # still-live triggers — exactly the no-diagnosis case the feature
        # exists to prevent. An out-of-order close leaves the chain intact
        # (our link dumps to a closed-but-valid dir; harmless).
        if getattr(self, "_installed_excepthook", None) is not None \
                and sys.excepthook is self._installed_excepthook:
            sys.excepthook = self._prev_excepthook
        if getattr(self, "_installed_sigterm", None) is not None:
            with contextlib.suppress(ValueError, OSError):
                if threading.current_thread() is threading.main_thread() \
                        and signal.getsignal(signal.SIGTERM) \
                        is self._installed_sigterm:
                    signal.signal(signal.SIGTERM, self._prev_sigterm)

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
