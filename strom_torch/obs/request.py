"""Causal request tracing (the port's copy of ``strom/obs/request.py``):
one ``req_id`` per gather, batch or pipeline step.

- A :class:`Request` is minted at each submission boundary (pipeline
  ``__next__``, ``_read_segments``, ``stream_segments``) and carried across
  threads explicitly (:func:`attach`) or implicitly on the minting thread
  through a ``contextvars.ContextVar``: nested mint sites reuse the
  enclosing request, so a batch's gather, scheduler waits and engine
  slices share one ``req_id``.
- Every span recorded through the request lands in the event ring with
  ``args={"req": id, "parent": <enclosing span>}`` and in the request's
  own bounded span tree, plus a Chrome-trace flow event per span.
- A request may carry a deadline (:meth:`Request.set_deadline_s`): the
  scheduler's queue waits, the engine's wait loops and the retry backoff
  stop at it and the gather fails with ``DeadlineExceeded``.
- At :meth:`Request.finish` the request's wall time feeds the tenant's
  ``req_lat`` histogram and ``req_total`` / ``req_throttled`` /
  ``req_errors`` in the stats registry, a ``req.done`` instant goes to the
  ring, and the registered observers are called.

No request active: every helper falls back to the plain ring emission.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
from typing import Callable

from strom_torch.obs.events import ring
from strom_torch.utils.locks import make_lock

# spans retained per request tree: enough for a batch-sized gather
# (sched slices + per-sample decode + per-device puts) without letting a
# runaway loop grow one exemplar without bound
MAX_SPANS_PER_REQUEST = 512

_req_ids = itertools.count(1)

_current: "contextvars.ContextVar[Request | None]" = \
    contextvars.ContextVar("strom_torch_request", default=None)

# finish-time observers: called with the finished Request under no locks,
# from a copy of the list taken under its lock
_observers: list[Callable] = []
_observers_lock = make_lock("obs.request_observers")


def add_observer(fn: Callable) -> None:
    with _observers_lock:
        if fn not in _observers:
            _observers.append(fn)


def remove_observer(fn: Callable) -> None:
    with _observers_lock:
        if fn in _observers:
            _observers.remove(fn)


class Request:
    """One traced request: identity, span tree, and terminal verdicts."""

    __slots__ = ("id", "kind", "tenant", "owner", "t0_us", "end_us",
                 "queue_wait_us", "throttled", "error", "spans",
                 "spans_dropped", "_open", "_lock", "_finished",
                 "_flow_started", "deadline")

    def __init__(self, kind: str, tenant: "str | None" = None,
                 owner: "object | None" = None):
        self.id = next(_req_ids)
        self.kind = kind
        self.tenant = tenant or "default"
        # the minting context's opaque token: observers are on a process-
        # global list, so a per-context observer filters to its own
        # requests (None = unowned, seen by all)
        self.owner = owner
        self.t0_us = ring.now_us()
        self.end_us: float | None = None
        self.queue_wait_us = 0.0        # accumulated scheduler queue waits
        self.throttled = False          # any grant waited on a budget bucket
        self.error: str | None = None
        # span tree: (name, cat, ts_us, dur_us, tid, parent-name-or-None)
        self.spans: list[tuple] = []
        self.spans_dropped = 0
        self._open: dict[int, list[str]] = {}   # tid -> open-span name stack
        self._lock = make_lock("obs.request")
        self._finished = False
        self._flow_started = False
        # deadline: absolute time.monotonic() seconds, or None.
        # Set once at mint (per-call deadline_s / config request_deadline_s);
        # the scheduler's queue waits, the engine's poll waits and the
        # retry scheduler all stop at it — the gather fails fast with
        # DeadlineExceeded instead of finishing into a dead SLO window.
        self.deadline: "float | None" = None

    def set_deadline_s(self, seconds: "float | None") -> None:
        """Arm a deadline *seconds* from now (None / <=0 = leave unset).
        First writer wins: a nested mint site must not shorten or extend
        the enclosing request's contract."""
        import time as _time

        if seconds is not None and seconds > 0 and self.deadline is None:
            self.deadline = _time.monotonic() + seconds

    # -- span emission -------------------------------------------------------
    def _flow(self, name: str, cat: str) -> None:
        """One flow event per recorded span: ``s`` for the request's
        first, ``t`` for every later one — Perfetto connects consecutive
        s/t events of one id into the request's arrow chain. Category and
        name are CONSTANT per request: the Trace Event Format binds flow
        chains by (cat, id), so reusing each span's own category would
        fragment one request into disconnected per-subsystem pieces."""
        with self._lock:
            first = not self._flow_started
            self._flow_started = True
        ring.flow("s" if first else "t", self.id, f"req.{self.kind}",
                  "req")

    def record(self, name: str, cat: str, ts_us: float, dur_us: float,
               args: "dict | None" = None, parent: "str | None" = None
               ) -> None:
        """One finished span: ring emission (req/parent in args) + tree
        append. The explicit-timestamp twin of :meth:`span` for callers
        that measured the window themselves (scheduler queue waits)."""
        tid = threading.get_ident()
        full = {"req": self.id}
        if parent:
            full["parent"] = parent
        if args:
            full.update(args)
        self._flow(name, cat)
        ring.complete(ts_us, dur_us, cat, name, full)
        with self._lock:
            if len(self.spans) < MAX_SPANS_PER_REQUEST:
                self.spans.append((name, cat, round(ts_us, 1),
                                   round(dur_us, 1), tid, parent))
            else:
                self.spans_dropped += 1

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", args: "dict | None" = None):
        """Record the with-block as one parent-linked request span (parent =
        the innermost still-open request span on THIS thread)."""
        tid = threading.get_ident()
        with self._lock:
            stack = self._open.setdefault(tid, [])
            parent = stack[-1] if stack else None
            stack.append(name)
        t0 = ring.now_us()
        try:
            yield
        finally:
            with self._lock:
                st = self._open.get(tid)
                if st and st[-1] == name:
                    st.pop()
            self.record(name, cat, t0, ring.now_us() - t0, args,
                        parent=parent)

    def parent_of(self, tid: "int | None" = None) -> "str | None":
        """The innermost open request span on *tid* (default: the calling
        thread) — for emission helpers that bypass :meth:`span`."""
        tid = threading.get_ident() if tid is None else tid
        with self._lock:
            st = self._open.get(tid)
            return st[-1] if st else None

    # -- terminal verdicts ---------------------------------------------------
    def note_queue_wait(self, wait_us: float, throttled: bool = False) -> None:
        with self._lock:
            self.queue_wait_us += wait_us
            self.throttled = self.throttled or throttled

    def mark_error(self, exc: BaseException) -> None:
        self.error = f"{type(exc).__name__}: {exc}"

    @property
    def dur_us(self) -> float:
        end = self.end_us if self.end_us is not None else ring.now_us()
        return max(end - self.t0_us, 0.0)

    def finish(self) -> None:
        """Terminal accounting, exactly once: req_lat into the tenant scope
        (labeled + aggregate), a ``req.done`` instant on the timeline, and
        the observer fan-out. Idempotent."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
        self.end_us = ring.now_us()
        from strom_torch.utils.stats import global_stats

        scope = global_stats.scoped(
            tenant=self.tenant if self.tenant != "default" else None)
        if self.kind != "step":
            # data-path requests only: a "step" request's wall is mostly
            # the consumer's own compute, and mixing it into req_lat would
            # turn the gather-latency percentiles into a train-step clock
            scope.observe_us("req_lat", self.dur_us)
        scope.add("req_total")
        if self.throttled:
            scope.add("req_throttled")
        if self.error:
            scope.add("req_errors")
        ring.instant("req.done", cat="req",
                     args={"req": self.id, "kind": self.kind,
                           "tenant": self.tenant,
                           "dur_us": round(self.dur_us, 1),
                           "queue_wait_us": round(self.queue_wait_us, 1),
                           "throttled": self.throttled,
                           "error": self.error})
        from strom_torch.obs.exemplars import store

        store.offer(self)
        with _observers_lock:
            obs = list(_observers)
        for fn in obs:
            with contextlib.suppress(Exception):
                fn(self)

    def to_doc(self) -> dict:
        """One JSON-able dict per request (the reference's exemplar shape)."""
        return {"req": self.id, "kind": self.kind, "tenant": self.tenant,
                "t0_us": round(self.t0_us, 1),
                "dur_us": round(self.dur_us, 1),
                "queue_wait_us": round(self.queue_wait_us, 1),
                "throttled": self.throttled, "error": self.error,
                "spans_dropped": self.spans_dropped,
                "spans": [{"name": n, "cat": c, "ts_us": ts, "dur_us": d,
                           "tid": tid, "parent": p}
                          for (n, c, ts, d, tid, p) in list(self.spans)]}


def current() -> "Request | None":
    return _current.get()


@contextlib.contextmanager
def active(kind: str, tenant: "str | None" = None,
           owner: "object | None" = None):
    """Mint (or reuse) the current request for the with-block. An enclosing
    request wins — nested mint sites (a streamed batch's gather inside the
    batch request) join it instead of forking the lane, keeping the
    encloser's owner — and only the minting site finishes it."""
    cur = _current.get()
    if cur is not None:
        yield cur
        return
    req = Request(kind, tenant, owner)
    tok = _current.set(req)
    try:
        yield req
    except BaseException as e:
        # StopIteration / GeneratorExit are control flow (a pipeline's
        # normal exhaustion ends its 'step' request this way), not request
        # failures: marking them errored would count req_errors every
        # finite epoch
        if not isinstance(e, (StopIteration, GeneratorExit)):
            req.mark_error(e)
        raise
    finally:
        _current.reset(tok)
        req.finish()


@contextlib.contextmanager
def attach(req: "Request | None"):
    """Re-enter an existing request on another thread (the streamed batch's
    pump thread). No-op when *req* is None."""
    if req is None:
        yield None
        return
    tok = _current.set(req)
    try:
        yield req
    finally:
        _current.reset(tok)


@contextlib.contextmanager
def span(name: str, cat: str = "", args: "dict | None" = None):
    """A request span when a request is active, else a plain ring span —
    instrumentation sites thread req_ids without caring whether tracing
    reached them."""
    req = _current.get()
    if req is None:
        with ring.span(name, cat, args):
            yield
    else:
        with req.span(name, cat, args):
            yield


def complete(ts_us: float, dur_us: float, cat: str, name: str,
             args: "dict | None" = None) -> None:
    """Explicit-window twin of :func:`span` (events that already measured
    their own window)."""
    req = _current.get()
    if req is None:
        ring.complete(ts_us, dur_us, cat, name, args)
    else:
        req.record(name, cat, ts_us, dur_us, args,
                   parent=req.parent_of())
