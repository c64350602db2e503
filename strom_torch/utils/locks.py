"""Named locks and an opt-in runtime lock-order witness (the port's copy
of ``strom/utils/locks.py``).

- :func:`make_lock` / :func:`make_condition` — the factory every
  lock-holding subsystem constructs through. Each lock carries a stable
  dotted NAME (``"cache.meta"``, ``"sched.arbiter"``) whose first segment
  is its band in the hierarchy ``scheduler → engine → slab pool → hot
  cache → stats/ring``.
- :class:`WitnessLock` — what the factory returns when the witness is on
  (``StromConfig.debug_locks`` / ``STROM_DEBUG_LOCKS=1``). Each acquire
  records the per-thread acquisition order into a process-wide lock
  graph keyed by lock NAME (role, not instance); acquiring B while
  holding A adds edge A→B with the first-seen ``file:line`` pair. An
  acquisition whose REVERSE path already exists raises a typed
  :class:`LockOrderError` naming the sites — before the inner lock is
  taken, so a seeded inversion shows as the raise, not a deadlock — and
  dumps a flight bundle (``STROM_FLIGHT_DIR`` / :func:`set_flight_dir`)
  so the cycle arrives with stacks attached.

When the witness is off (the default) the factory returns plain
``threading.Lock`` / ``threading.Condition`` objects. Locks created
BEFORE the witness is enabled stay plain: enable it through the env var
(covers module-level locks created at import) or ``StromConfig.debug_locks``
(enabled first thing in ``StromContext.__init__``, before the engine and
every subsystem lock is constructed, and reverted by its ``close()``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

__all__ = [
    "LockOrderError", "WitnessLock", "make_lock", "make_condition",
    "witness_enabled", "enable_witness", "set_flight_dir", "witness",
]


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes",
                                                        "on")


_enabled = _env_truthy("STROM_DEBUG_LOCKS")
_flight_dir: "str | None" = os.environ.get("STROM_FLIGHT_DIR") or None


def witness_enabled() -> bool:
    return _enabled


def enable_witness(on: bool = True) -> None:
    """Turn the witness on/off for locks constructed FROM NOW ON.
    Existing plain locks stay plain; existing WitnessLocks keep
    witnessing (the graph itself is always live)."""
    global _enabled
    _enabled = on


def set_flight_dir(path: "str | None") -> None:
    """Where a cycle dumps its flight bundle (None = don't dump)."""
    global _flight_dir
    _flight_dir = path


class LockOrderError(RuntimeError):
    """A lock acquisition that closes a cycle in the observed order graph.

    ``edge`` is the offending (held_name, acquiring_name) pair; ``sites``
    maps every edge of the cycle — the new one plus the already-observed
    path back from the acquired lock to the held one (one edge for a
    direct inversion, several for a multi-lock cycle) — to the
    ``file:line -> file:line`` pair where it was first observed: the call
    sites a fix has to reconcile.
    """

    def __init__(self, held: str, acquiring: str, forward_site: str,
                 reverse_path: "list[tuple[str, str, str]]"):
        self.edge = (held, acquiring)
        self.sites = {f"{held} -> {acquiring}": forward_site}
        for a, b, site in reverse_path:
            self.sites[f"{a} -> {b}"] = site
        lines = "\n".join(f"  {edge} at {site}"
                          for edge, site in self.sites.items())
        kind = "inversion" if len(reverse_path) == 1 else \
            f"{len(reverse_path) + 1}-lock cycle"
        super().__init__(
            f"lock order {kind}: acquiring '{acquiring}' while holding "
            f"'{held}', but '{acquiring}' already reaches '{held}' in the "
            f"observed acquisition graph.\n{lines}")


def _caller_site() -> str:
    """file:line of the acquiring frame (first frame outside this module
    and outside threading.py — Condition.wait re-acquires through both)."""
    f = sys._getframe(1)
    here = __file__
    thr = threading.__file__
    while f is not None and f.f_code.co_filename in (here, thr):
        f = f.f_back
    if f is None:
        return "?"
    return f"{os.path.relpath(f.f_code.co_filename)}:{f.f_lineno}"


class _Witness:
    """Process-wide acquisition-order graph + per-thread held stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # (held_name, acquired_name) -> "held_site -> acquired_site"
        self._edges: dict[tuple[str, str], str] = {}
        self._tls = threading.local()
        self.cycles = 0

    # -- per-thread stack ---------------------------------------------------
    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def _in_dump(self) -> bool:
        return getattr(self._tls, "dumping", False)

    def _path_locked(self, src: str, dst: str
                     ) -> "list[tuple[str, str, str]] | None":
        """BFS path src→…→dst over the observed edges, as
        ``[(a, b, first_seen_site), ...]``; None when unreachable. A
        direct reverse edge is the 1-hop case; longer paths are the
        3-lock-and-up cycles a pairwise check would miss."""
        if src == dst:
            return None
        parents: dict[str, "tuple[str, str] | None"] = {src: None}
        frontier = [src]
        while frontier:
            nxt = []
            for node in frontier:
                for (a, b), site in self._edges.items():
                    if a != node or b in parents:
                        continue
                    parents[b] = (a, site)
                    if b == dst:
                        path = []
                        cur = dst
                        while parents[cur] is not None:
                            pa, psite = parents[cur]
                            path.append((pa, cur, psite))
                            cur = pa
                        path.reverse()
                        return path
                    nxt.append(b)
            frontier = nxt
        return None

    # -- the check ----------------------------------------------------------
    def before_acquire(self, name: str) -> None:
        """Validate acquiring *name* against this thread's held set and the
        process graph. Raises :class:`LockOrderError` BEFORE the real lock
        is touched when the acquired lock already REACHES any held lock in
        the observed graph (direct reverse edge or a longer cycle)."""
        if self._in_dump():
            return
        held = self._held()
        if not held:
            return
        site = _caller_site()
        err = None
        with self._mu:
            for h_name, h_site in held:
                if h_name == name:
                    continue  # same role re-entered (distinct instances)
                rev = self._path_locked(name, h_name)
                if rev is not None:
                    self.cycles += 1
                    err = LockOrderError(h_name, name,
                                         f"{h_site} -> {site}", rev)
                    break
            else:
                for h_name, h_site in held:
                    if h_name == name:
                        continue
                    self._edges.setdefault((h_name, name),
                                           f"{h_site} -> {site}")
                return
        self._dump(err)
        raise err

    def note_acquired(self, name: str) -> None:
        if not self._in_dump():
            self._held().append((name, _caller_site()))

    def note_released(self, name: str) -> None:
        if self._in_dump():
            return
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                del held[i]
                return

    # -- introspection ------------------------------------------------------
    def edges(self) -> dict[str, str]:
        with self._mu:
            return {f"{a} -> {b}": site
                    for (a, b), site in sorted(self._edges.items())}

    def reset(self) -> None:
        """Drop the graph (tests seed inversions; one test's edges must not
        convict the next test's legal order)."""
        with self._mu:
            self._edges.clear()

    # -- cycle bundle -------------------------------------------------------
    def _dump(self, err: LockOrderError) -> None:
        """Best-effort flight bundle at the moment of the cycle. Runs with
        the witness bypassed for this thread: the capture walks stats and
        the event ring, and tripping (or re-checking) the witness from
        inside its own failure handler would recurse."""
        if _flight_dir is None:
            return
        self._tls.dumping = True
        try:
            with contextlib.suppress(Exception):
                from strom_torch.obs.flight import dump_capture

                dump_capture(_flight_dir, reason="lock_order",
                             note=str(err))
        finally:
            self._tls.dumping = False


witness = _Witness()


class WitnessLock:
    """A named ``threading.Lock`` that feeds the order witness.

    Duck-types the Lock API (``acquire``/``release``/``locked``/context
    manager) closely enough for ``threading.Condition`` to wrap one, so
    :func:`make_condition` is just ``Condition(WitnessLock(name))`` —
    ``wait()`` releases through our ``release`` and re-acquires through
    our ``acquire``, keeping the per-thread held stack truthful across
    the wait window.
    """

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner=None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        witness.before_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            witness.note_acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        witness.note_released(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name!r} {self._inner!r}>"


def make_lock(name: str):
    """A named mutex. Plain ``threading.Lock`` normally; a
    :class:`WitnessLock` when the witness is on. *name* is dotted
    ``band.role`` — the first segment is the lock's band in the canonical
    hierarchy (scheduler → engine → slab pool → hot cache → stats/ring)."""
    if _enabled:
        return WitnessLock(name)
    return threading.Lock()


def make_condition(name: str):
    """A named condition variable (its internal lock rides the witness
    when enabled)."""
    if _enabled:
        return threading.Condition(WitnessLock(name))
    return threading.Condition()
