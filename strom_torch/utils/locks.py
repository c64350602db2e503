"""Named locks (the port's copy of ``make_lock`` from
``strom/utils/locks.py``).

The reference builds every lock of its request tracing, resilience and
fault layers through :func:`make_lock` so a lock-order witness can wrap
them when ``debug_locks`` is on. The port has no witness yet: the name is
kept at every call site, and a plain ``threading.Lock`` comes back.
"""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    """A mutex named ``band.role`` (the reference's lock hierarchy key);
    a plain ``threading.Lock`` here."""
    del name
    return threading.Lock()
