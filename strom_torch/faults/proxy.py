"""FaultyEngine (the port's copy of ``strom/faults/proxy.py``): an engine
proxy that applies a :class:`~strom_torch.faults.plan.FaultPlan`.

Wraps any :class:`strom_torch.engine.base.Engine` and interposes on the
submit/wait edges, so the generic gather machinery (``read_vectored``,
``submit_vectored``/``poll``/``drain``/``cancel``, inherited from the base
class and driven against this engine's submit_raw/wait) runs every fault
through the retry, backoff and deadline policy real reads use:

- ``errno`` / ``engine_death``: the op never reaches the inner engine; a
  failed completion is delivered on the next wait (death latches: every
  later op fails the same way, at once).
- ``short_read``: the op runs; its completion is reported truncated to
  ``keep_bytes`` (the retry re-reads the whole piece).
- ``bit_flip``: the op runs; one RNG-chosen bit of the landed data is
  flipped before the completion is delivered (reads only).
- ``latency``: the op runs; its completion is held for ``latency_s``.
- ``stuck``: the op runs; its completion is swallowed (forever, or until
  ``release_s``). ``cancel``/``close`` release stuck completions at once
  (as ``-ECANCELED``) so teardown stays bounded; so does
  :meth:`FaultyEngine.release_stuck`.

The proxy is ``concurrent_gathers = False`` whatever the inner engine
says: the delivery layer serializes transfers around it.
"""

from __future__ import annotations

import contextlib
import errno as _errno
import time
from typing import Sequence

import numpy as np

from strom_torch.engine.base import (Completion, Engine, EngineError,
                                     RawRead, RawWrite, ReadRequest)
from strom_torch.faults.plan import Fault, FaultPlan
from strom_torch.utils.locks import make_lock


class FaultyEngine(Engine):
    name = "faulty"
    concurrent_gathers = False  # see module docstring

    def __init__(self, inner: Engine, plan: FaultPlan, *, scope=None):
        super().__init__(inner.config)
        self.inner = inner
        self.plan = plan
        self.name = f"faulty+{inner.name}"
        if scope is not None:
            self.set_scope(scope)
        self._lock = make_lock("faults.proxy")
        self._paths: dict[int, str] = {}
        # synthetic completions ready for the next wait (errno / death)
        self._synth: list[Completion] = []
        # held completions: (release_monotonic_s | None, Completion) —
        # latency holds carry a release time, stuck holds None (or their
        # release_s deadline); None releases only via cancel/close
        self._held: list[tuple["float | None", Completion]] = []
        # tag -> (Fault, request) for ops whose fault applies at completion
        self._tag_faults: dict[int, tuple[Fault, object]] = {}

    # -- delegation ----------------------------------------------------------
    def register_file(self, path: str, *, o_direct: "bool | None" = None,
                      writable: bool = False) -> int:
        fi = self.inner.register_file(path, o_direct=o_direct,
                                      writable=writable)
        with self._lock:
            self._paths[fi] = path
        return fi

    def unregister_file(self, file_index: int) -> None:
        with self._lock:
            self._paths.pop(file_index, None)
        self.inner.unregister_file(file_index)

    def file_uses_o_direct(self, file_index: int) -> bool:
        return self.inner.file_uses_o_direct(file_index)

    def buffer(self, buf_index: int) -> np.ndarray:
        return self.inner.buffer(buf_index)

    def buffer_info(self) -> dict:
        info = self.inner.buffer_info()
        info["engine"] = self.name
        return info

    def register_dest(self, arr: np.ndarray) -> int:
        return self.inner.register_dest(arr)

    def unregister_dest(self, arr: np.ndarray) -> None:
        self.inner.unregister_dest(arr)

    def unregister_dest_addr(self, addr: int) -> None:
        self.inner.unregister_dest_addr(addr)

    def set_scope(self, scope) -> None:
        self._op_scope = scope
        self.inner.set_scope(scope)

    def in_flight(self) -> int:
        with self._lock:
            mine = len(self._synth) + len(self._held)
        return self.inner.in_flight() + mine

    def stats(self) -> dict:
        snap = self.inner.stats()
        snap["engine"] = self.name
        snap["faults"] = self.plan.stats()
        return snap

    # -- the fault choke point ----------------------------------------------
    @staticmethod
    def _tenant() -> "str | None":
        from strom_torch.obs import request as _request

        req = _request.current()
        return req.tenant if req is not None else None

    def _decide(self, req) -> "Fault | None":
        with self._lock:
            path = self._paths.get(req.file_index)
        f = self.plan.decide(path=path, offset=req.offset,
                             length=req.length, tenant=self._tenant(),
                             op="write" if isinstance(req, RawWrite)
                             else "read")
        if f is not None:
            with contextlib.suppress(Exception):
                self.op_scope.add("faults_injected")
        return f

    def _submit_some(self, requests: Sequence) -> int:
        """Shared submit/submit_raw body: decide per op; synthetic-fail the
        ops a rule kills outright, pass the rest to the inner engine with
        completion-time faults registered by tag."""
        self._note_submitted(requests)
        passthrough = []
        caller_pos = []   # caller index per passthrough entry
        synth_added = []  # (caller index, tag) synthetically failed here
        for i, r in enumerate(requests):
            f = self._decide(r)
            if f is None:
                passthrough.append(r)
                caller_pos.append(i)
                continue
            if f.kind in ("errno", "engine_death", "hangup"):
                # hangup is a peer-op kind; presented to an engine op by a
                # direction-less rule it degrades to a plain transient
                # errno (engines have no stream to drop)
                with self._lock:
                    self._synth.append(Completion(r.tag, -f.err))
                synth_added.append((i, r.tag, f))
                continue
            with self._lock:
                self._tag_faults[r.tag] = (f, r)
            passthrough.append(r)
            caller_pos.append(i)
        if passthrough:
            try:
                if isinstance(passthrough[0], (RawRead, RawWrite)):
                    self.inner.submit_raw(passthrough)
                else:
                    self.inner.submit(passthrough)
            except EngineError as e:
                # the inner .accepted counts the filtered passthrough list;
                # the caller slices its request list (requests[accepted:]
                # re-backlogged by base._pump_token) so translate to the
                # caller index of the first unaccepted op, and roll back
                # this call's bookkeeping past that point: fault
                # registrations for ops not in the ring, and synthetic
                # completions for ops the caller will resubmit (their
                # replay will re-decide)
                acc = max(int(getattr(e, "accepted", 0) or 0), 0)
                caller_acc = caller_pos[acc] if acc < len(passthrough) \
                    else len(requests)
                unwound = []
                with self._lock:
                    for r in passthrough[acc:]:
                        ent = self._tag_faults.pop(r.tag, None)
                        if ent is not None:
                            unwound.append(ent[0])
                    drop = set()
                    for ci, t, f in synth_added:
                        if ci >= caller_acc:
                            drop.add(t)
                            unwound.append(f)
                    if drop:
                        self._synth = [c for c in self._synth
                                       if c.tag not in drop]
                # the rolled-back ops never ran: un-count their decided
                # injections (times caps, tallies, the scope counter) so
                # the replay re-decides against an unspent budget
                for f in unwound:
                    self.plan.unwind(f)
                if unwound:
                    with contextlib.suppress(Exception):
                        self.op_scope.add("faults_injected", -len(unwound))
                e.accepted = caller_acc
                raise
        return len(requests)

    def submit(self, requests: Sequence[ReadRequest]) -> int:
        return self._submit_some(requests)

    def submit_raw(self, requests: Sequence[RawRead]) -> int:
        return self._submit_some(requests)

    # -- completion transform ------------------------------------------------
    def _flip(self, f: Fault, req) -> None:
        """Apply the bit_flip to the landed bytes (silent corruption)."""
        try:
            if isinstance(req, RawRead):
                view = req.dest.view(np.uint8).reshape(-1)
                off = min(f.flip_offset, req.length - 1)
            else:
                view = self.inner.buffer(req.buf_index)
                off = req.buf_offset + min(f.flip_offset, req.length - 1)
            view[off] ^= f.flip_mask
        # a flip that cannot land (read-only view, zero-length op) degrades
        # to a no-op injection; the plan already counted the decision
        except (ValueError, IndexError, TypeError):
            pass

    def _transform(self, c: Completion) -> "Completion | None":
        """Apply a completion-time fault; None = held (not delivered)."""
        with self._lock:
            ent = self._tag_faults.pop(c.tag, None)
        if ent is None:
            return c
        f, req = ent
        if c.result < 0:
            return c  # the op failed for real; the injected fault is moot
        if f.kind == "short_read":
            return Completion(c.tag, min(c.result, f.keep_bytes))
        if f.kind == "bit_flip":
            self._flip(f, req)
            return c
        if f.kind == "latency":
            with self._lock:
                self._held.append((time.monotonic() + f.latency_s, c))
            return None
        # stuck: swallowed until release_s (None = until cancel/close)
        rel = None if f.release_s is None \
            else time.monotonic() + f.release_s
        with self._lock:
            self._held.append((rel, c))
        return None

    def _release_due(self) -> list[Completion]:
        now = time.monotonic()
        with self._lock:
            out = [c for t, c in self._held if t is not None and t <= now]
            if out:
                self._held = [(t, c) for t, c in self._held
                              if t is None or t > now]
            out.extend(self._synth)
            self._synth.clear()
        return out

    def _next_release_s(self) -> "float | None":
        with self._lock:
            times = [t for t, _ in self._held if t is not None]
        return max(min(times) - time.monotonic(), 0.0) if times else None

    def release_stuck(self, result: "int | None" = -_errno.ECANCELED) -> int:
        """Deliver every indefinitely-held completion now — with its real
        result (``result=None``) or an override (default ``-ECANCELED``).
        cancel/close call this so a stuck fault can't wedge teardown."""
        with self._lock:
            stuck = [(t, c) for t, c in self._held if t is None]
            if not stuck:
                return 0
            self._held = [(t, c) for t, c in self._held if t is not None]
            for _, c in stuck:
                self._synth.append(c if result is None
                                   else Completion(c.tag, result))
        return len(stuck)

    def wait(self, min_completions: int = 1,
             timeout_s: "float | None" = None) -> list[Completion]:
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        out: list[Completion] = []
        while True:
            out.extend(self._release_due())
            # opportunistically drain whatever the inner engine has ready
            for c in self.inner.wait(min_completions=1, timeout_s=0.0):
                tc = self._transform(c)
                if tc is not None:
                    out.append(tc)
            if len(out) >= min_completions:
                break
            # block on the inner engine, but wake for the next held
            # release and the caller deadline
            slice_s = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            nxt = self._next_release_s()
            if nxt is not None:
                slice_s = nxt if slice_s is None else min(slice_s, nxt)
            if slice_s is not None and slice_s <= 0:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                continue
            got = self.inner.wait(min_completions=1,
                                  timeout_s=slice_s if slice_s is not None
                                  else 0.25)
            for c in got:
                tc = self._transform(c)
                if tc is not None:
                    out.append(tc)
            if deadline is not None and not got \
                    and time.monotonic() >= deadline:
                out.extend(self._release_due())
                break
        if out:
            self._note_completed(out)
        return out

    # -- lifecycle -----------------------------------------------------------
    def cancel(self, token, timeout_s: "float | None" = None) -> None:
        # stuck completions release as -ECANCELED FIRST: the reap loop in
        # the base cancel then retires them instantly instead of burning
        # the whole timeout on completions that were never coming
        self.release_stuck()
        super().cancel(token, timeout_s)

    def close(self) -> None:
        self.release_stuck()
        self._cancel_live_tokens()
        self.inner.close()
        self._forget_abandoned()
