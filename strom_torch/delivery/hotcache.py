"""Hot-set host cache and epoch-aware readahead (the port's copy of
``strom/delivery/hotcache.py``).

The pipelines re-gather the same bytes from NVMe every epoch even when the
working set fits in host RAM. :class:`HotCache` is an extent-keyed,
byte-budgeted, refcounted LRU of host byte ranges that the delivery layer
(``StromContext._read_segments`` and the streamed gather) consults before
engine submission: a full hit never touches the engine, a partial hit
submits only the miss runs.

- **Stable keys.** Entries key on ``(physical path, byte range)`` after
  extent and stripe expansion: caller segments are batch-relative and
  coalesce differently per shuffle order, physical ranges repeat across
  epochs. Interval arithmetic serves overlaps, so a differently split
  request still hits.
- **Second-touch admission** (``hot_cache_admit="second_touch"``): the
  first epoch only observes (a block-granular touch ledger, bounded LRU),
  the second admits; ``"always"`` admits on first read. Readahead always
  force-admits.
- **Refcounted eviction.** Entries are pinned while anything reads them;
  eviction skips pinned entries, and an entry evicted while pinned frees
  its buffer only on the last unpin.
- **Readahead yields to demand.** :class:`Readahead` warms the sampler's
  upcoming-batch window (``EpochShuffleSampler.peek``, which crosses the
  epoch boundary) through ``StromContext.warm``, in slices of the engine's
  in-flight budget, and stops a pass when a demand read is in flight.

Buffers: entries are fresh page-aligned allocations (``alloc_aligned``),
billed at their size class (``size_class``). The port's slab pool pins every slab for
CUDA; cache-served bytes are copied into the batch's pinned slab, and the
device copy reads that slab, never a cache buffer. The reference's
telemetry mirrors stay on :meth:`HotCache.stats`.

- **The spill tier.** With a :class:`~strom_torch.delivery.spill.SpillTier`
  attached (``spill``; the context attaches one for ``spill_bytes > 0``),
  an entry evicted under byte pressure is offered to it after the cache's
  lock is released (:meth:`HotCache._demote_and_free`), and the delivery
  consult serves it from there. A full or closed spill file degrades to a
  plain drop (counted ``spill_errors``). Invalidated and cleared entries
  never demote: their bytes are stale or unwanted.
"""

from __future__ import annotations

import bisect
import threading
from collections import OrderedDict
from typing import Any, Callable, Iterable

import numpy as np

from strom_torch.delivery.buffers import alloc_aligned, size_class

ADMIT_POLICIES = ("second_touch", "always")


class _Entry:
    """One cached physical range: ``buf[:hi-lo]`` holds file bytes [lo, hi)
    of ``skey``. ``refs`` pins it against eviction; ``dead`` marks an entry
    evicted while pinned (freed on last unpin). ``charge`` is what the byte
    budget is billed: the buffer's allocated size class, not the logical
    length."""

    __slots__ = ("skey", "lo", "hi", "buf", "refs", "dead", "charge",
                 "tenant", "demote")

    def __init__(self, skey: Any, lo: int, hi: int, buf: np.ndarray,
                 charge: int, tenant: "str | None" = None):
        self.skey = skey
        self.lo = lo
        self.hi = hi
        self.buf = buf
        self.refs = 0
        self.dead = False
        self.charge = charge
        # owning tenant for partition accounting (None: the shared budget)
        self.tenant = tenant
        # evicted under byte pressure with a spill tier attached: the
        # freeing caller demotes the bytes before dropping the buffer
        self.demote = False

    @property
    def nbytes(self) -> int:
        return self.hi - self.lo


class HotCache:
    """Extent-keyed, byte-budgeted, refcounted LRU of host byte ranges.

    Thread-safe: metadata mutates under one lock; the byte copies happen
    outside it with the source entries pinned. Buffers are fresh aligned
    allocations; the GC unmaps a freed one.
    """

    def __init__(self, max_bytes: int, *,
                 admit: str = "second_touch", block_bytes: int = 1 << 20,
                 touch_capacity: int = 1 << 16, scope=None):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        if admit not in ADMIT_POLICIES:
            raise ValueError(f"admit must be one of {ADMIT_POLICIES}, "
                             f"got {admit!r}")
        if block_bytes <= 0:
            raise ValueError("block_bytes must be positive")
        self.max_bytes = max_bytes
        self.admit_policy = admit
        self._block = block_bytes
        # the NVMe spill tier evictions demote to (None: evictions drop)
        self.spill = None
        # telemetry scope of the owning context (spill_errors)
        from strom_torch.utils.stats import global_stats

        self._scope = scope if scope is not None else global_stats
        self.spill_errors = 0
        # a disabled cache serves, admits and warms nothing (entries kept)
        self.enabled = True
        self._lock = threading.Lock()
        # skey -> entries sorted by lo (disjoint ranges per skey)
        self._index: dict[Any, list[_Entry]] = {}
        # LRU: oldest first; the key is the entry's id()
        self._lru: "OrderedDict[int, _Entry]" = OrderedDict()
        # block-granular touch ledger for second-touch admission, bounded
        self._touched: "OrderedDict[tuple, None]" = OrderedDict()
        self._touch_cap = touch_capacity
        self.bytes = 0
        # per-tenant partitions: tenant -> byte cap within the shared budget
        self._partitions: dict[str, int] = {}
        self._tenant_bytes: dict[str, int] = {}
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.hits = 0
        self.misses = 0
        self.admitted_bytes = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.readahead_bytes = 0
        self.readahead_yields = 0
        self.readahead_errors = 0

    # -- lookup / pinning ---------------------------------------------------
    def lookup(self, skey: Any, lo: int, hi: int, *, record: bool = True,
               count_misses: bool = True
               ) -> tuple[list[tuple[int, int, np.ndarray]],
                          list[tuple[int, int]], list[_Entry]]:
        """Split [lo, hi) of *skey* into cached and missing ranges.

        Returns ``(hits, misses, pinned)``: hits are ``(h_lo, h_hi, view)``
        with *view* a zero-copy window of the entry's buffer; *pinned* holds
        the entries behind those views with their refcount raised. The
        caller MUST :meth:`unpin` them once it stops reading the views.
        ``record=False`` skips the hit/miss counters (readahead probes);
        ``count_misses=False`` leaves only the miss counters to the caller
        (:meth:`note_miss`)."""
        hits: list[tuple[int, int, np.ndarray]] = []
        misses: list[tuple[int, int]] = []
        pinned: list[_Entry] = []
        with self._lock:
            entries = self._index.get(skey, ())
            i = bisect.bisect_right(entries, lo, key=lambda e: e.lo) - 1 \
                if entries else 0
            i = max(i, 0)
            pos = lo
            while pos < hi and i < len(entries):
                e = entries[i]
                if e.hi <= pos:
                    i += 1
                    continue
                if e.lo >= hi:
                    break
                if e.lo > pos:
                    misses.append((pos, e.lo))
                    pos = e.lo
                s, t = max(pos, e.lo), min(hi, e.hi)
                e.refs += 1
                pinned.append(e)
                self._lru.move_to_end(id(e))
                hits.append((s, t, e.buf[s - e.lo: t - e.lo]))
                pos = t
                i += 1
            if pos < hi:
                misses.append((pos, hi))
            if record:
                self.hit_bytes += sum(t - s for s, t, _ in hits)
                self.hits += len(hits)
                if count_misses:
                    self.miss_bytes += sum(t - s for s, t in misses)
                    self.misses += len(misses)
        return hits, misses, pinned

    def note_miss(self, nbytes: int, n: int = 1) -> None:
        """Count a miss whose counting :meth:`lookup` left to the caller."""
        if nbytes <= 0:
            return
        with self._lock:
            self.miss_bytes += nbytes
            self.misses += n

    def view(self, skey: Any, lo: int, hi: int, *, record: bool = True
             ) -> tuple[np.ndarray, _Entry] | None:
        """One pinned zero-copy view when ONE entry covers all of [lo, hi),
        else None. The caller must :meth:`unpin` the entry."""
        with self._lock:
            entries = self._index.get(skey, ())
            if not entries:
                return None
            i = bisect.bisect_right(entries, lo, key=lambda e: e.lo) - 1
            if i < 0:
                return None
            e = entries[i]
            if not (e.lo <= lo and hi <= e.hi):
                return None
            e.refs += 1
            self._lru.move_to_end(id(e))
            if record:
                self.hit_bytes += hi - lo
                self.hits += 1
        return e.buf[lo - e.lo: hi - e.lo], e

    def unpin(self, entries: Iterable[_Entry]) -> None:
        """Drop pins taken by :meth:`lookup`/:meth:`view`; frees the buffer
        of any entry that was evicted while pinned."""
        with self._lock:
            for e in entries:
                e.refs -= 1
                if e.dead and e.refs == 0:
                    e.buf = None  # type: ignore[assignment]

    def _demote_and_free(self, e: _Entry, buf: np.ndarray) -> None:
        """Outside-the-lock half of eviction: offer the evicted bytes to
        the spill tier when one is attached and the eviction wanted it;
        dropping the last reference then frees the buffer. A spill failure
        is counted, never raised: losing a demotion costs a later source
        read, the spill-less cache's behaviour."""
        sp = self.spill
        if e.demote and sp is not None and e.skey is not None:
            try:
                sp.offer(e.skey, e.lo, e.hi, buf[: e.nbytes],
                         tenant=e.tenant)
            except Exception:
                with self._lock:
                    self.spill_errors += 1
                self._scope.add("spill_errors")

    # -- admission / eviction -----------------------------------------------
    def _blocks(self, skey: Any, lo: int, hi: int) -> list[tuple]:
        return [(skey, b) for b in range(lo // self._block,
                                         (hi - 1) // self._block + 1)]

    def _touch(self, blocks: list[tuple]) -> bool:
        """Mark blocks touched; True when EVERY block had been touched
        before (the second-touch admission test)."""
        seen = all(b in self._touched for b in blocks)
        for b in blocks:
            self._touched[b] = None
            self._touched.move_to_end(b)
        while len(self._touched) > self._touch_cap:
            self._touched.popitem(last=False)
        return seen

    def set_partition(self, tenant: str, max_bytes: int) -> None:
        """Cap *tenant*'s resident bytes at *max_bytes* (0 removes the
        partition). Enforced from the next admission."""
        with self._lock:
            if max_bytes <= 0:
                self._partitions.pop(tenant, None)
            else:
                self._partitions[tenant] = int(max_bytes)

    def partitions(self) -> dict:
        """{tenant: {"max_bytes", "bytes"}}."""
        with self._lock:
            return {t: {"max_bytes": m,
                        "bytes": self._tenant_bytes.get(t, 0)}
                    for t, m in self._partitions.items()}

    def admit(self, skey: Any, lo: int, hi: int, data: np.ndarray, *,
              force: bool = False, tenant: "str | None" = None) -> int:
        """Offer file bytes [lo, hi) of *skey* (``data`` holds them).
        Subject to the admission policy (unless *force*), the byte budget
        (LRU eviction of unpinned entries makes room) and disjointness
        (already-cached subranges are skipped). Returns bytes admitted."""
        n = hi - lo
        if n <= 0 or size_class(n) > self.max_bytes:
            return 0
        with self._lock:
            if not force and self.admit_policy == "second_touch" \
                    and not self._touch(self._blocks(skey, lo, hi)):
                return 0
        # gaps only, so entries stay disjoint; unpin the overlapped ones
        _, gaps, pinned = self.lookup(skey, lo, hi, record=False)
        self.unpin(pinned)
        admitted = 0
        for g_lo, g_hi in gaps:
            admitted += self._insert(skey, g_lo, g_hi,
                                     data[g_lo - lo: g_hi - lo],
                                     tenant=tenant)
        if admitted:
            with self._lock:
                self.admitted_bytes += admitted
        return admitted

    def _insert(self, skey: Any, lo: int, hi: int, data: np.ndarray, *,
                tenant: "str | None" = None) -> int:
        n = hi - lo
        charge = size_class(n)
        buf = alloc_aligned(n)
        buf[:n] = data[:n]
        # victims are collected under the lock and freed after it
        to_free: list[tuple[_Entry, np.ndarray]] = []
        with self._lock:
            # a tenant over its partition first evicts its OWN unpinned
            # entries; admission is refused if the cap still can't fit it
            refused = False
            cap = self._partitions.get(tenant) if tenant is not None else None
            if cap is not None:
                if charge > cap:
                    refused = True
                else:
                    while self._tenant_bytes.get(tenant, 0) + charge > cap:
                        victim = next(
                            (e for e in self._lru.values()
                             if e.refs == 0 and e.tenant == tenant), None)
                        if victim is None:
                            break
                        to_free.extend(self._evict_locked(victim))
                    if self._tenant_bytes.get(tenant, 0) + charge > cap:
                        refused = True
            # make room in the shared budget, never freeing a pinned entry
            while not refused and self.bytes + charge > self.max_bytes:
                victim = next((e for e in self._lru.values() if e.refs == 0),
                              None)
                if victim is None:
                    break
                to_free.extend(self._evict_locked(victim))
            admitted = False
            if not refused and self.bytes + charge <= self.max_bytes:
                # a concurrent admit may have covered part of this gap
                # since our lookup: keep entries disjoint
                entries = self._index.setdefault(skey, [])
                i = bisect.bisect_right(entries, lo, key=lambda e: e.lo)
                prev_ok = i == 0 or entries[i - 1].hi <= lo
                next_ok = i == len(entries) or entries[i].lo >= hi
                if prev_ok and next_ok:
                    e = _Entry(skey, lo, hi, buf, charge, tenant)
                    entries.insert(i, e)
                    self._lru[id(e)] = e
                    self.bytes += charge
                    if tenant is not None:
                        self._tenant_bytes[tenant] = \
                            self._tenant_bytes.get(tenant, 0) + charge
                    admitted = True
        for victim, victim_buf in to_free:
            self._demote_and_free(victim, victim_buf)
        return n if admitted else 0

    def _evict_locked(self, e: _Entry, *, demote: bool = True
                      ) -> list[tuple[_Entry, np.ndarray]]:
        """Remove *e* from the index and LRU (lock held). Returns the
        (entry, buffer) pairs the caller demotes and frees after releasing
        the lock; a pinned entry returns nothing and frees, without
        demoting, on its last unpin. ``demote=False`` drops without
        spilling."""
        self._lru.pop(id(e), None)
        entries = self._index.get(e.skey)
        if entries is not None:
            i = bisect.bisect_right(entries, e.lo, key=lambda x: x.lo) - 1
            if 0 <= i < len(entries) and entries[i] is e:
                entries.pop(i)
            if not entries:
                del self._index[e.skey]
        self.bytes -= e.charge
        if e.tenant is not None:
            left = self._tenant_bytes.get(e.tenant, 0) - e.charge
            if left > 0:
                self._tenant_bytes[e.tenant] = left
            else:
                self._tenant_bytes.pop(e.tenant, None)
        self.evictions += 1
        self.evicted_bytes += e.nbytes
        e.demote = demote and self.spill is not None
        if e.refs == 0:
            buf, e.buf = e.buf, None  # type: ignore[assignment]
            return [(e, buf)]
        e.dead = True  # the last unpin frees it
        return []

    def invalidate(self, skey: Any) -> int:
        """Drop every entry of *skey* and of any derived tuple key that
        embeds it (decoded frames key as ``("jpegdec", path, lo, hi,
        fp)``), in this tier and in the spill tier, without demoting: the
        backing bytes changed. Returns entries dropped here. Pinned entries
        leave the index at once and free on the last unpin."""
        dropped = 0
        with self._lock:
            keys = [k for k in self._index
                    if k == skey or (isinstance(k, tuple) and skey in k)]
            for k in keys:
                for e in list(self._index.get(k, ())):
                    dropped += 1
                    self._evict_locked(e, demote=False)
        if self.spill is not None:
            self.spill.invalidate(skey)
        return dropped

    def clear(self) -> None:
        """Drop every entry AND the touch ledger. Pinned entries leave the
        index at once; their buffers free on the last unpin."""
        with self._lock:
            for e in list(self._lru.values()):
                self._evict_locked(e, demote=False)
            self._touched.clear()

    # -- readahead accounting ----------------------------------------------
    def note_readahead(self, nbytes: int) -> None:
        with self._lock:
            self.readahead_bytes += nbytes

    def note_yield(self) -> None:
        with self._lock:
            self.readahead_yields += 1

    def note_error(self) -> None:
        """A readahead tick died (the window function raised, a source
        vanished): counted, so a broken readahead differs from one with
        nothing to warm."""
        with self._lock:
            self.readahead_errors += 1

    # -- introspection ------------------------------------------------------
    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._lru)

    def manifest(self, *, max_entries: int = 4096) -> list[list]:
        """Resident path-keyed ranges, newest first, as ``[path, lo, hi]``
        triples; derived tuple keys (decoded frames) are skipped."""
        out: list[list] = []
        with self._lock:
            for e in reversed(self._lru.values()):
                if len(out) >= max_entries:
                    break
                if isinstance(e.skey, str):
                    out.append([e.skey, e.lo, e.hi])
        return out

    def stats(self) -> dict:
        """The ``cache`` section of ``StromContext.stats()``."""
        with self._lock:
            served = self.hit_bytes + self.miss_bytes
            ratio = self.hit_bytes / served if served else 0.0
            return {
                "cache_budget_bytes": self.max_bytes,
                "cache_bytes": self.bytes,
                "cache_entries": len(self._lru),
                "cache_hit_bytes": self.hit_bytes,
                "cache_miss_bytes": self.miss_bytes,
                "cache_hits": self.hits,
                "cache_misses": self.misses,
                "cache_admitted_bytes": self.admitted_bytes,
                "cache_evictions": self.evictions,
                "cache_evicted_bytes": self.evicted_bytes,
                "cache_readahead_bytes": self.readahead_bytes,
                "cache_readahead_yields": self.readahead_yields,
                "cache_readahead_errors": self.readahead_errors,
                "cache_hit_ratio": round(ratio, 4),
            }


class Readahead:
    """Epoch-aware readahead: warm the upcoming-batch window into the cache.

    *window_fn* returns an iterable of ``(source, segments, base_offset)``
    read requests for the next ``window_batches`` batches (the pipelines
    build it from ``EpochShuffleSampler.peek``); it is called with
    ``window_batches``. Each tick re-pulls the window, so
    the thread follows the sampler as the prefetcher advances it; a fully
    warm window backs off to a longer sleep. All warming goes through
    ``StromContext.warm``, which reads only misses, force-admits them and
    yields to demand reads between slices.
    """

    def __init__(self, ctx, window_fn: Callable[[int], Iterable[tuple]], *,
                 interval_s: float = 0.02, tenant: "str | None" = None,
                 window_batches: int = 0):
        self._ctx = ctx
        self._window_fn = window_fn
        self._interval = interval_s
        self.window_batches = int(window_batches)
        # the pipeline this thread warms for: admitted entries charge its
        # cache partition (the engine reads ride the background
        # "readahead" tenant)
        self._tenant = tenant
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="strom-readahead")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            cache = getattr(self._ctx, "hot_cache", None)
            if cache is None or not cache.enabled:
                # before window_fn: building the window is the CPU a
                # disabled cache must not pay
                self._stop.wait(self._interval * 5)
                continue
            warmed = 0
            try:
                for source, segments, base_offset in \
                        self._window_fn(self.window_batches):
                    if self._stop.is_set():
                        break
                    warmed += self._ctx.warm(source, segments, base_offset,
                                             tenant=self._tenant)
            # an advisory path: a racing close or a transient engine error
            # must not kill the thread, but it is counted
            except Exception:
                cache = getattr(self._ctx, "hot_cache", None)
                if cache is not None:
                    cache.note_error()
            self._stop.wait(self._interval if warmed else self._interval * 5)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
