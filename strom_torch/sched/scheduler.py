"""Shared I/O scheduler: many tenants, one engine (the port's copy of
``strom/sched/scheduler.py``).

Without a scheduler a context lets one gather at a time own the engine
(its engine lock, held for the whole transfer), so a second pipeline's
small read queues behind a first pipeline's epoch gather.
:class:`IoScheduler` replaces that lock:

- **Per-tenant queues, priority classes.** Each grant request enters its
  tenant's FIFO. Classes are strict among budget-ready work
  (``interactive`` > ``training`` > ``background``); a class whose every
  queued tenant is budget-throttled yields to lower classes rather than
  idling the engine.
- **Weighted fair drain.** Within a class the queued tenant with the least
  weighted service (``nbytes / weight`` charged per grant) goes next; a
  tenant that turns active joins at the current baseline, so idle time
  banks no credit.
- **Slices.** Exclusive grants hand the engine to one request at a time,
  and the delivery layer cuts big gathers into slices of a few in-flight
  windows (:meth:`read_chunks`), so ownership turns over every slice. On an
  engine that arbitrates itself (``concurrent_gathers``, the multi-ring
  engine) grants are not exclusive: budgets and accounting still apply,
  queueing does not.
- **Budgets and admission control** (:mod:`strom_torch.sched.budget`).
- **Deadlines.** A grant request whose traced request
  (``obs.request.current()``) carries a deadline leaves the queue when the
  deadline passes (``DeadlineExceeded``, counted in ``deadline_exceeded``),
  and a sliced gather stops at the first slice boundary past it. The
  queue wait is noted on that request (its ``req_throttled`` outcome).
- **Spans.** On a traced request's lane: ``sched.queue`` (the queue wait),
  ``sched.grant`` (the engine-ownership window) and ``engine.slice`` (one
  slice's engine gather, ``cat="read"`` or ``"write"``).

Every grant adds ``sched_granted_ops`` / ``sched_granted_bytes`` and a
``sched_queue_wait_us`` observation to the tenant's scope (and so to the
unlabelled aggregate); ``sched_throttle_waits`` counts grants that waited
on a budget.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Sequence

from strom_torch.engine.base import DeadlineExceeded
from strom_torch.obs import request as _request
from strom_torch.obs.events import ring as _ring
from strom_torch.sched.budget import AdmissionGate
from strom_torch.sched.tenant import PRIORITIES, PRIORITY_ORDER, Tenant
from strom_torch.utils.locks import make_condition

# the per-tenant columns the multitenant measurement prints (the
# reference's bench_multitenant names)
SCHED_FIELDS = (
    "items_per_s",
    "vs_solo",
    "sched_queue_wait_p50_us",
    "sched_queue_wait_p99_us",
    "sched_granted_ops",
    "sched_granted_bytes",
    "sched_throttle_waits",
    "engine_op_lat_p99_us",
)

_DEFAULT_TENANT = "default"


class _Waiter:
    """One queued grant request (owned by the scheduler's lock)."""

    __slots__ = ("tenant", "nbytes", "prio", "enq_t", "granted", "wait_s",
                 "throttled", "owner_ident")

    def __init__(self, tenant: Tenant, nbytes: int, prio: int, enq_t: float):
        self.tenant = tenant
        self.nbytes = nbytes
        self.prio = prio
        self.enq_t = enq_t
        self.granted = False
        self.wait_s = 0.0
        # one sched_throttle_waits per throttled grant, however many
        # dispatch passes observe it
        self.throttled = False
        # the thread that acquired the grant (a streamed gather may release
        # it on another): the key held_by_me() counts under
        self.owner_ident = 0


class IoScheduler:
    """Fair arbiter over one engine's transfer path. *clock* is injectable
    for deterministic tests."""

    def __init__(self, engine, config, *, pool=None, scope=None,
                 clock: Callable[[], float] = time.monotonic):
        from strom_torch.utils.stats import global_stats

        self.engine = engine
        self.config = config
        self._scope = scope if scope is not None else global_stats
        self._clock = clock
        # engines that arbitrate per ring keep their concurrency
        self.exclusive = not getattr(engine, "concurrent_gathers", False)
        # a live slice size (the reference's autotuner writes it; None
        # defers to the config)
        self.slice_bytes_override: int | None = None
        self._cond = make_condition("sched.arbiter")
        self._tenants: dict[str, Tenant] = {}
        self._current: _Waiter | None = None
        # grants outstanding per acquiring thread: a thread that holds one
        # must never queue a nested one (a self-deadlock on an exclusive
        # engine); the spill tier's engine route asks held_by_me() first
        self._held_by: dict[int, int] = {}
        # service baseline a newly active tenant joins at
        self._vbase = 0.0
        self.admission = AdmissionGate(
            pool, getattr(config, "sched_high_water", 0.9),
            scope=self._scope, clock=clock)
        # set by the owning context (ctx.slo.burning): tenants_info rows
        # flag a tenant that burns its error budget, and the scheduler
        # stays SLO-agnostic
        self.slo_hook: "Callable[[str], bool] | None" = None
        # set by the owning context (ctx.resilience.stats): the breaker's
        # and the failover's state beside the queue rows
        self.resilience_info: "Callable[[], dict] | None" = None
        self._default = self.register(_DEFAULT_TENANT, _label=False)

    # -- tenant registry ----------------------------------------------------
    def register(self, name: str, *, priority: str = "training",
                 weight: int = 1, byte_rate: float = 0,
                 byte_burst: float | None = None, iops: float = 0,
                 hot_cache_bytes: int = 0, _label: bool = True) -> Tenant:
        """Register (or fetch) tenant *name*. Registering a name again
        returns the live handle unchanged. ``_label=False`` keeps the
        context's own scope (the default tenant)."""
        with self._cond:
            t = self._tenants.get(name)
            if t is not None:
                return t
            scope = self._scope.scoped(tenant=name) if _label else self._scope
            t = Tenant(name, priority=priority, weight=weight, scope=scope,
                       byte_rate=byte_rate, byte_burst=byte_burst, iops=iops,
                       hot_cache_bytes=hot_cache_bytes, clock=self._clock)
            t.vtime = self._vbase
            self._tenants[name] = t
            return t

    def is_registered(self, name: str) -> bool:
        with self._cond:
            return name in self._tenants

    def tenant(self, name: str | None = None) -> Tenant:
        if name is None:
            return self._default
        with self._cond:
            t = self._tenants.get(name)
        # a name seen first here registers with the defaults
        return t if t is not None else self.register(name)

    def resolve(self, tenant: "Tenant | str | None") -> Tenant:
        if isinstance(tenant, Tenant):
            return tenant
        return self.tenant(tenant)

    def tenants_info(self) -> dict:
        """``{"tenants": {name: row}, "admission": ..., ...}``: the
        ``/tenants`` route body. With an ``slo_hook`` each row carries
        ``slo_burning``; with ``resilience_info`` the body carries the
        breaker's state."""
        with self._cond:
            tenants = list(self._tenants.values())
        rows = {}
        for t in tenants:
            row = t.info()
            if self.slo_hook is not None:
                with contextlib.suppress(Exception):
                    row["slo_burning"] = bool(self.slo_hook(t.name))
            rows[t.name] = row
        out = {"tenants": rows,
               "admission": self.admission.state(),
               "exclusive": self.exclusive,
               "engine": getattr(self.engine, "name", "?")}
        if self.resilience_info is not None:
            with contextlib.suppress(Exception):
                out["resilience"] = self.resilience_info()
        return out

    # -- the fair-drain core ------------------------------------------------
    def _enqueue_locked(self, w: _Waiter) -> None:
        """Append a waiter; a tenant turning active from idle joins at the
        current service baseline."""
        t = w.tenant
        if not t.queue and not t.active and t.vtime < self._vbase:
            t.vtime = self._vbase
        t.queue.append(w)
        t.queued_bytes += w.nbytes

    def _pick_locked(self) -> tuple[_Waiter | None, float | None]:
        """(next grantable waiter, earliest budget-ready delay): strict
        priority between classes, least weighted service within one;
        budgets peeked, not taken."""
        min_delay: float | None = None
        for cls in range(len(PRIORITIES)):
            cand = [t for t in self._tenants.values()
                    if t.queue and t.queue[0].prio == cls]
            for t in sorted(cand, key=lambda t: (t.vtime, t.name)):
                w = t.queue[0]
                d = max(t.byte_bucket.peek(w.nbytes),
                        t.iops_bucket.peek(1))
                if d > 0:
                    self._note_throttled_locked(w)
                    min_delay = d if min_delay is None else min(min_delay, d)
                    continue
                return w, min_delay
            # every queued tenant of this class is throttled: fall through
            # to the next class (work conservation)
        return None, min_delay

    @staticmethod
    def _note_throttled_locked(w: _Waiter) -> None:
        if w.throttled:
            return
        w.throttled = True
        w.tenant.throttle_waits += 1
        w.tenant.scope.add("sched_throttle_waits")

    def _commit_grant_locked(self, w: _Waiter) -> None:
        """Dequeue, take the budgets, charge weighted service, count."""
        t = w.tenant
        t.queue.popleft()
        t.queued_bytes -= w.nbytes
        t.byte_bucket.take(w.nbytes)
        t.iops_bucket.take(1)
        t.vtime += w.nbytes / t.weight
        if t.vtime > self._vbase:
            self._vbase = t.vtime
        t.active += 1
        t.granted_ops += 1
        t.granted_bytes += w.nbytes
        w.granted = True

    def _dispatch_locked(self) -> float | None:
        """Grant the next waiter if the engine is free; the retry delay
        when everything grantable is throttled."""
        if self._current is not None:
            return None
        w, delay = self._pick_locked()
        if w is None:
            return delay
        self._commit_grant_locked(w)
        self._current = w
        self._cond.notify_all()
        return None

    def acquire(self, tenant: "Tenant | str | None" = None,
                nbytes: int = 0, *, priority: str | None = None) -> _Waiter:
        """Queue for, and block until, an engine grant; pass the handle to
        :meth:`release`. Non-exclusive engines grant at once (budgets still
        charged, throttles still wait). A waiter whose request deadline
        passes leaves the queue and raises DeadlineExceeded."""
        t = self.resolve(tenant)
        prio = PRIORITY_ORDER[priority] if priority is not None \
            else PRIORITY_ORDER[t.priority]
        w = _Waiter(t, max(int(nbytes), 0), prio, self._clock())
        enq_us = _ring.now_us()
        # deadlines ride time.monotonic (the engine's clock), not the
        # injectable scheduler clock
        req = _request.current()
        req_deadline = req.deadline if req is not None else None

        def _expired() -> bool:
            return req_deadline is not None \
                and time.monotonic() >= req_deadline

        def _abort_locked() -> None:
            with contextlib.suppress(ValueError):
                t.queue.remove(w)
                t.queued_bytes -= w.nbytes
            t.scope.set_gauge("sched_queue_depth", len(t.queue))
            t.scope.add("deadline_exceeded")
            self._cond.notify_all()

        with self._cond:
            self._enqueue_locked(w)
            t.scope.set_gauge("sched_queue_depth", len(t.queue))
            if not self.exclusive:
                while t.queue[0] is not w or \
                        max(t.byte_bucket.peek(w.nbytes),
                            t.iops_bucket.peek(1)) > 0:
                    if _expired():
                        _abort_locked()
                        raise DeadlineExceeded(
                            f"queued on tenant '{t.name}' (throttled)")
                    if t.queue[0] is w:
                        d = max(t.byte_bucket.peek(w.nbytes),
                                t.iops_bucket.peek(1))
                        self._note_throttled_locked(w)
                        self._cond.wait(min(d, 0.05))
                    else:
                        self._cond.wait(0.01)
                self._commit_grant_locked(w)
                self._cond.notify_all()
            else:
                delay = self._dispatch_locked()
                while self._current is not w:
                    if _expired():
                        _abort_locked()
                        raise DeadlineExceeded(
                            f"queued on tenant '{t.name}' behind "
                            f"{len(t.queue)} op(s)")
                    wait_s = delay
                    if req_deadline is not None:
                        left = max(req_deadline - time.monotonic(), 0.001)
                        wait_s = left if wait_s is None \
                            else min(wait_s, left)
                    self._cond.wait(wait_s)
                    delay = self._dispatch_locked()
            t.scope.set_gauge("sched_queue_depth", len(t.queue))
            w.owner_ident = threading.get_ident()
            self._held_by[w.owner_ident] = \
                self._held_by.get(w.owner_ident, 0) + 1
        w.wait_s = max(self._clock() - w.enq_t, 0.0)
        t.scope.observe_us("sched_queue_wait", w.wait_s * 1e6)
        t.scope.add("sched_granted_ops")
        if w.nbytes:
            t.scope.add("sched_granted_bytes", w.nbytes)
        if req is not None:
            # the queue wait on the request's lane, throttled verdict
            # included (the exemplar store keys off it)
            req.note_queue_wait(w.wait_s * 1e6, throttled=w.throttled)
            req.record("sched.queue", "sched", enq_us,
                       _ring.now_us() - enq_us,
                       args={"tenant": t.name, "bytes": w.nbytes,
                             "throttled": w.throttled},
                       parent=req.parent_of())
        if self.exclusive and t.scope is not self._scope:
            # one owner at a time: the engine's per-op latency goes to the
            # tenant's scope for the grant, back to the context's at release
            self.engine.set_scope(t.scope)
        return w

    def release(self, w: _Waiter) -> None:
        if self.exclusive:
            self.engine.set_scope(self._scope)
        with self._cond:
            w.tenant.active -= 1
            left = self._held_by.get(w.owner_ident, 0) - 1
            if left > 0:
                self._held_by[w.owner_ident] = left
            else:
                self._held_by.pop(w.owner_ident, None)
            if self.exclusive and self._current is w:
                self._current = None
                self._dispatch_locked()
            self._cond.notify_all()

    # -- re-entrancy probes (the spill tier's engine route) -----------------
    def held_by_me(self) -> bool:
        """True when the calling thread acquired a grant still outstanding:
        a nested enqueue from it would self-deadlock on an exclusive
        engine."""
        with self._cond:
            return self._held_by.get(threading.get_ident(), 0) > 0

    def engine_idle(self) -> bool:
        """Advisory: no exclusive grant outstanding now. The spill tier's
        engine writes require it (a demotion fired mid-gather on a thread
        other than the grant's holder must not queue behind that grant).
        A stale answer either queues normally or takes the fallback."""
        if not self.exclusive:
            return True
        return self._current is None

    @contextlib.contextmanager
    def grant(self, tenant: "Tenant | str | None" = None, nbytes: int = 0,
              *, priority: str | None = None):
        """``with sched.grant(tenant, nbytes):``, the scheduler's form of
        ``with ctx._engine_lock:``. The ownership window is a
        ``sched.grant`` span on the current request's lane."""
        # the request and its parent are taken at entry: the exit may run
        # on another thread (a streamed gather releases at drain)
        req = _request.current()
        parent = req.parent_of() if req is not None else None
        w = self.acquire(tenant, nbytes, priority=priority)
        grant_us = _ring.now_us()
        try:
            yield w
        finally:
            self.release(w)
            if req is not None:
                req.record("sched.grant", "sched", grant_us,
                           _ring.now_us() - grant_us,
                           args={"tenant": w.tenant.name,
                                 "bytes": w.nbytes},
                           parent=parent)

    # -- sliced gather execution (the delivery hot path) --------------------
    def _slice_bytes(self) -> int:
        ov = self.slice_bytes_override
        if ov is not None and ov >= 0:
            return int(ov)
        sb = getattr(self.config, "sched_slice_bytes", -1)
        if sb >= 0:
            return sb
        # auto: four in-flight windows a grant, deep enough to amortise the
        # hand-off, shallow enough that ownership turns over quickly
        return 4 * self.config.queue_depth * self.config.block_size

    def iter_slices(self, chunks: Sequence[tuple[int, int, int, int]]):
        """Cut a gather's chunk list into slices of about
        ``sched_slice_bytes``. Order is kept and no chunk is split."""
        limit = self._slice_bytes()
        if limit <= 0:
            yield list(chunks)
            return
        batch: list[tuple[int, int, int, int]] = []
        b = 0
        for c in chunks:
            batch.append(c)
            b += c[3]
            if b >= limit:
                yield batch
                batch, b = [], 0
        if batch:
            yield batch

    def read_chunks(self, chunks: Sequence[tuple[int, int, int, int]],
                    dest, *, tenant: "Tenant | str | None" = None,
                    retries: int = 1, priority: str | None = None) -> int:
        """Run a planned gather one grant a slice: byte-identical to
        ``engine.read_vectored(chunks, dest)``, and a concurrent tenant
        waits behind at most about one slice of it. Past the request's
        deadline the gather stops at the next slice boundary."""
        return self._sliced(self.engine.read_vectored, "read", chunks, dest,
                            tenant, retries, priority)

    def _sliced(self, run, cat: str, chunks, buf, tenant, retries: int,
                priority: str | None) -> int:
        t = self.resolve(tenant)
        req = _request.current()
        req_deadline = req.deadline if req is not None else None
        total = 0
        for si, sl in enumerate(self.iter_slices(chunks)):
            if req_deadline is not None \
                    and time.monotonic() >= req_deadline:
                t.scope.add("deadline_exceeded")
                raise DeadlineExceeded(
                    f"{cat} stopped at slice {si} ({total} bytes landed)")
            nbytes = sum(ln for (_, _, _, ln) in sl)
            with self.grant(t, nbytes, priority=priority), \
                    _request.span("engine.slice", cat=cat,
                                  args={"slice": si, "ops": len(sl),
                                        "bytes": nbytes}):
                total += run(sl, buf, retries=retries)
        return total

    def write_chunks(self, chunks: Sequence[tuple[int, int, int, int]],
                     src, *, tenant: "Tenant | str | None" = None,
                     retries: int = 1, priority: str | None = None) -> int:
        """The write twin of :meth:`read_chunks`: a planned scatter of
        (file_index, file_offset, src_offset, length) chunks out of *src*,
        one grant a slice, stopped at a slice boundary past the deadline."""
        return self._sliced(self.engine.write_vectored, "write", chunks, src,
                            tenant, retries, priority)

    # -- drain --------------------------------------------------------------
    def drain(self, tenant: "Tenant | str | None" = None,
              timeout_s: float = 30.0) -> bool:
        """Wait until *tenant* has nothing queued and no grant held. True
        when drained, False on timeout."""
        t = self.resolve(tenant)
        deadline = self._clock() + timeout_s
        with self._cond:
            while t.queue or t.active:
                left = deadline - self._clock()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
        return True

    def drain_all(self, timeout_s: float = 30.0) -> list[str]:
        """Drain every tenant; the names that did not drain in time."""
        with self._cond:
            names = list(self._tenants)
        deadline = self._clock() + timeout_s
        stuck = []
        for name in names:
            left = max(deadline - self._clock(), 0.01)
            if not self.drain(name, timeout_s=left):
                stuck.append(name)
        return stuck

    def stats(self) -> dict:
        """The ``sched`` section of ``StromContext.stats()``."""
        with self._cond:
            tenants = list(self._tenants.values())
        return {
            "sched_tenants": len(tenants),
            "sched_queued_ops": sum(len(t.queue) for t in tenants),
            "sched_queued_bytes": sum(t.queued_bytes for t in tenants),
            "sched_active_grants": sum(t.active for t in tenants),
            "sched_granted_ops": sum(t.granted_ops for t in tenants),
            "sched_granted_bytes": sum(t.granted_bytes for t in tenants),
            "sched_throttle_waits": sum(t.throttle_waits for t in tenants),
            "sched_exclusive": self.exclusive,
            "slab_pool_admission_waits": self.admission.waits,
        }
