"""Consistent-hash extent directory (the port's copy of
``strom/dist/directory.py``: the same ring, so both packages name the same
owners).

A static launch-time ``owner_fn`` is right for a fixed fleet, but a host
that dies mid-epoch leaves every survivor asking a stale owner. This
module is the membership-aware owner map:

- :class:`HashRing`: a consistent-hash ring with virtual nodes, a pure
  function of the sorted membership set (every point is
  ``sha256(f"{member}#{vnode}")``), so hosts that agree on the membership
  agree on every owner with no coordination. Dropping one member moves
  only the keys that member owned.
- :class:`ExtentDirectory`: the live owner map the peer tier consults. It
  keeps a membership *epoch* (one more on every change) and publishes and
  learns deaths through the launcher's rendezvous directory:
  ``mark_dead`` (fed by the peer tier's breaker trips) writes a
  ``ring_dead_<name>`` marker, and every survivor's throttled
  :meth:`poll` reads the markers and recomputes its ring, so the fleet
  converges on the smaller membership within one poll interval. Until
  that poll the old owner is still asked: its open breaker turns those
  probes into ``peer_skips``, and the engine serves the range.

Ring keys default to the path's basename (``key_fn``): shard files sit in
run-local directories that differ between launches, and ownership must be
a function of the dataset, not of where it was staged.
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import os
import time
from typing import Callable, Iterable

from strom_torch.utils.locks import make_lock

# virtual nodes per member: enough points that dropping one member
# redistributes its keys roughly evenly across the survivors
DEFAULT_VNODES = 64
# a death marker in the rendezvous dir: ``ring_dead_<member>`` — distinct
# from the launcher's ``dead_<rank>`` worker-exit markers so barrier
# tolerance and ring membership stay independently testable
RING_DEAD_PREFIX = "ring_dead_"


def _hval(s: str) -> int:
    """64-bit ring position — sha256-derived so every host computes the
    identical ring with no shared seed."""
    return int.from_bytes(hashlib.sha256(s.encode("utf-8")).digest()[:8],
                          "big")


class HashRing:
    """Immutable consistent-hash ring over a membership set.

    Deterministic from the (sorted) members and the vnode count alone;
    :meth:`owner` maps any string key to the member owning the first ring
    point at or clockwise of the key's hash.
    """

    __slots__ = ("_members", "_points", "_owners", "vnodes")

    def __init__(self, members: Iterable, vnodes: int = DEFAULT_VNODES):
        self.vnodes = int(vnodes)
        self._members = tuple(sorted(set(members), key=str))
        pts: list[tuple[int, object]] = []
        for m in self._members:
            for i in range(self.vnodes):
                pts.append((_hval(f"{m}#{i}"), m))
        pts.sort(key=lambda kv: (kv[0], str(kv[1])))
        self._points = [h for h, _ in pts]
        self._owners = [m for _, m in pts]

    @property
    def members(self) -> tuple:
        return self._members

    def owner(self, key: str):
        """The member owning *key*, or None on an empty ring."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, _hval(str(key)))
        return self._owners[i % len(self._owners)]


class ExtentDirectory:
    """Membership-epoch owner map for the peer tier.

    *members* is the full launch-time roster (the launcher uses ranks);
    *self_name* is this host's entry. :meth:`owner` answers the peer tier:
    the owning peer's name, or None when this host owns the key itself
    (read locally) or nobody live does (straight to the engine).

    Death propagation is two-step by design: :meth:`mark_dead` PUBLISHES
    the death (a ``ring_dead_<name>`` marker in the rendezvous dir) but
    the membership change is APPLIED only by the next throttled
    :meth:`poll` — on this host and every survivor alike, so the whole
    fleet re-owns from the same marker set instead of each host's private
    breaker timeline. Without a rendezvous dir (unit tests, single-host
    tools) mark_dead applies immediately.
    """

    def __init__(self, members: Iterable, self_name, *,
                 vnodes: int = DEFAULT_VNODES,
                 rendezvous_dir: "str | None" = None,
                 key_fn: "Callable[[str], str] | None" = None,
                 poll_interval_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self._all = tuple(sorted(set(members), key=str))
        self._by_str = {str(m): m for m in self._all}
        self._self = self_name
        self._vnodes = int(vnodes)
        self._dir = rendezvous_dir
        self._key_fn = key_fn if key_fn is not None else os.path.basename
        self._poll_s = float(poll_interval_s)
        self._clock = clock
        self._next_poll = 0.0
        # leaf lock: guards the dead set / ring swap / epoch, never held
        # across filesystem or socket I/O (listdir happens outside it)
        self._lock = make_lock("dist.directory")
        self._dead: set = set()
        self._ring = HashRing(self._all, self._vnodes)
        self.epoch = 0

    # -- owner resolution ----------------------------------------------------
    def ring_owner(self, path: str):
        """The raw owning member for *path* — self included (the warm
        phase asks "are these bytes mine to pay the SSD read for?")."""
        self._maybe_poll()
        return self._ring.owner(self._key_fn(path))

    def owner(self, path: str):
        """The peer tier's question: the owning PEER's name, or None when
        this host owns the key (or the ring is empty)."""
        o = self.ring_owner(path)
        return None if o is None or o == self._self else o

    @property
    def live(self) -> tuple:
        with self._lock:
            return self._ring.members

    # -- membership ----------------------------------------------------------
    def mark_dead(self, name) -> None:
        """Publish *name*'s death. With a rendezvous dir the marker lands
        there and the change applies at the next poll (fleet-wide);
        without one it applies immediately."""
        if name not in self._by_str.values() or name == self._self:
            return
        if self._dir is not None:
            self._publish_dead(name)
            return
        self._apply(dead={name}, alive=set())

    def mark_alive(self, name) -> None:
        """Re-admit *name* (a restarted host): removes its marker and
        re-owns its keys back."""
        if self._dir is not None:
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(self._dir,
                                       f"{RING_DEAD_PREFIX}{name}"))
        self._apply(dead=set(), alive={name})

    def poll(self) -> bool:
        """Read the rendezvous dir's death markers and apply any
        membership change now. Returns True when the epoch bumped."""
        if self._dir is None:
            return False
        try:
            names = os.listdir(self._dir)
        except OSError:
            return False
        dead = set()
        for f in names:
            if f.startswith(RING_DEAD_PREFIX):
                m = self._by_str.get(f[len(RING_DEAD_PREFIX):])
                if m is not None and m != self._self:
                    dead.add(m)
        with self._lock:
            alive = self._dead - dead
            fresh = dead - self._dead
        if not fresh and not alive:
            return False
        return self._apply(dead=fresh, alive=alive)

    def _maybe_poll(self) -> None:
        if self._dir is None:
            return
        now = self._clock()
        if now < self._next_poll:
            return
        self._next_poll = now + self._poll_s
        self.poll()

    def _publish_dead(self, name) -> None:
        path = os.path.join(self._dir, f"{RING_DEAD_PREFIX}{name}")
        tmp = f"{path}.tmp-{os.getpid()}"
        with contextlib.suppress(OSError):
            with open(tmp, "w") as f:
                f.write(str(self._self))
            os.replace(tmp, path)

    def _apply(self, *, dead: set, alive: set) -> bool:
        with self._lock:
            before = set(self._dead)
            self._dead |= dead
            self._dead -= alive
            if self._dead == before:
                return False
            members = [m for m in self._all if m not in self._dead]
            self._ring = HashRing(members, self._vnodes)
            self.epoch += 1
        return True

    # -- introspection -------------------------------------------------------
    def info(self) -> dict:
        with self._lock:
            return {"epoch": self.epoch,
                    "members": [str(m) for m in self._all],
                    "dead": sorted(str(m) for m in self._dead),
                    "vnodes": self._vnodes}
