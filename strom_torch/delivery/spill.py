"""NVMe spill tier under the hot-set cache (the port's copy of
``strom/delivery/spill.py``).

Without it the hot cache is one RAM tier: an entry evicted under byte
pressure vanishes, and the next request for those bytes pays a full source
gather. Evicted ranges instead DEMOTE to a spill file on local NVMe, and
the delivery layer's cache consult serves them from there, never from the
source engine: RAM → NVMe → source. Decoded-frame entries (tuple keys)
demote like any other.

- **Same keys, same interval arithmetic** as the hot cache: entries key
  on the physical path (or the decoded-frame tuple) with [lo, hi) ranges,
  served by intersection. A skey's entries stay disjoint (a range already
  spilled is skipped: source bytes are immutable).
- **Refcounted, two-phase I/O.** File I/O never runs under the tier's
  lock: ``offer`` allocates file space under it, writes outside it, then
  publishes the entry; ``lookup`` pins entries under it and the caller
  reads outside it (``read_into``) and unpins after. Eviction skips pinned
  entries; a pinned entry evicted recycles its slot on the last unpin.
- **Size-class allocator.** Spill-file space is allocated at
  :func:`~strom_torch.delivery.buffers.size_class` granularity with free
  lists per class, so a churning cache recycles slots instead of growing
  the file; ``max_bytes`` caps the allocated bytes, and room is made by
  dropping the oldest unpinned entries (below this tier there is only the
  source).
- **Per-tenant partitions**: entries carry the evicting tenant;
  ``set_partition`` caps a tenant's spill bytes, and a tenant over its cap
  drops its own oldest entries first.

Counters: ``spill_*`` (the measured ones named in :data:`SPILL_FIELDS`).
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
from collections import OrderedDict
from typing import Any

import numpy as np

from strom_torch.delivery.buffers import size_class

# the columns the spill epoch measurement prints (the reference's
# bench_checkpoint spill pass names)
SPILL_FIELDS = (
    "spill_hit_bytes",
    "spill_hits",
    "spill_spilled_bytes",
    "spill_entries",
    "spill_bytes",
    "spill_hit_ratio",
    "spill_cache_miss_bytes",
    "spill_promote_bytes",
    "spill_engine_ops",
    "spill_fallback_ops",
)


class _SpillEntry:
    """One spilled range: spill_file[off : off + stored] holds bytes
    [lo, hi) of *skey* — raw (``codec`` None, ``stored`` == hi-lo) or
    compressed (``codec`` names the codec, ``stored`` is the on-disk
    payload length). ``cls`` is the size-class-rounded file
    allocation the occupancy budget is billed; ``refs`` pins against
    eviction (the caller is mid-pread); ``dead`` marks
    evicted-while-pinned (slot recycles on last unpin)."""

    __slots__ = ("skey", "lo", "hi", "off", "cls", "refs", "dead", "tenant",
                 "codec", "stored")

    def __init__(self, skey: Any, lo: int, hi: int, off: int, cls: int,
                 tenant: "str | None", *, codec: "str | None" = None,
                 stored: "int | None" = None):
        self.skey = skey
        self.lo = lo
        self.hi = hi
        self.off = off
        self.cls = cls
        self.refs = 0
        self.dead = False
        self.tenant = tenant
        self.codec = codec
        self.stored = (hi - lo) if stored is None else stored

    @property
    def nbytes(self) -> int:
        return self.hi - self.lo


class SpillTier:
    """Byte-budgeted spill file with per-skey disjoint ranges, refcounted
    entries and per-tenant accounting. Thread-safe; all file I/O runs
    outside the tier lock (see module docstring)."""

    def __init__(self, path: str, max_bytes: int, *, scope=None, io=None,
                 compress: bool = False):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        from strom_torch.utils.stats import global_stats

        self.path = path
        self.max_bytes = max_bytes
        # demote compression: the probed codec, engaged per entry only when
        # it pays (raw otherwise, utils/codec.py); None = raw entries only
        self._codec = None
        if compress:
            from strom_torch.utils.codec import default_codec

            self._codec = default_codec()
        self._scope = scope if scope is not None else global_stats
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        # engine I/O router: an object with write(data_u8, off) -> bool and
        # read(dest_u8, off, n) -> bool that routes spill bytes through the
        # context's engine (O_DIRECT, background-class scheduler grants)
        # when it is safe to enqueue, and returns False to ask for the
        # buffered fd below (strom_torch.delivery.core._SpillEngineIo).
        # None = always the buffered fd (spill_engine_io=False).
        self._io = io
        self._lock = threading.Lock()
        self._index: dict[Any, list[_SpillEntry]] = {}
        self._lru: "OrderedDict[int, _SpillEntry]" = OrderedDict()
        self._free: dict[int, list[int]] = {}   # class -> file offsets
        self._next_off = 0
        self.bytes = 0                          # allocated (class-rounded)
        self._tenant_bytes: dict[str, int] = {}
        self._partitions: dict[str, int] = {}
        self._closed = False
        # tallies (authoritative for stats(); mirrored into the scope)
        self.hit_bytes = 0
        self.hits = 0
        self.miss_bytes = 0
        self.misses = 0
        self.spilled_bytes = 0
        self.spills = 0
        self.evictions = 0
        # readahead-driven spill → RAM promotions, counted by the warm
        # consult
        self.promote_bytes = 0
        # which route spill bytes took (engine vs buffered-fd fallback)
        self.engine_ops = 0
        self.fallback_ops = 0
        # compression accounting (COMP_FIELDS contract): raw bytes entering
        # the codec vs stored bytes leaving it, and served decompressions
        self.comp_bytes_in = 0
        self.comp_bytes_out = 0
        self.decomp_bytes = 0

    # -- allocator (lock held) ----------------------------------------------
    def _alloc_locked(self, n: int, tenant: "str | None") -> "int | None":
        """A file offset for an n-byte entry, or None when no room can be
        made. Evicts oldest unpinned entries (the tenant's own first when
        it is over its partition) to fit the budget."""
        cls = size_class(n)
        cap = self._partitions.get(tenant) if tenant is not None else None
        if cap is not None:
            if cls > cap:
                return None
            while self._tenant_bytes.get(tenant, 0) + cls > cap:
                victim = next((e for e in self._lru.values()
                               if e.refs == 0 and e.tenant == tenant), None)
                if victim is None:
                    return None
                self._evict_locked(victim)
        while self.bytes + cls > self.max_bytes:
            victim = next((e for e in self._lru.values() if e.refs == 0),
                          None)
            if victim is None:
                return None
            self._evict_locked(victim)
        bucket = self._free.get(cls)
        if bucket:
            off = bucket.pop()
        else:
            off = self._next_off
            self._next_off += cls
        self.bytes += cls
        if tenant is not None:
            self._tenant_bytes[tenant] = \
                self._tenant_bytes.get(tenant, 0) + cls
        return off

    def _release_slot_locked(self, e: _SpillEntry) -> None:
        self._free.setdefault(e.cls, []).append(e.off)
        self.bytes -= e.cls
        if e.tenant is not None:
            left = self._tenant_bytes.get(e.tenant, 0) - e.cls
            if left > 0:
                self._tenant_bytes[e.tenant] = left
            else:
                self._tenant_bytes.pop(e.tenant, None)

    def _evict_locked(self, e: _SpillEntry) -> None:
        """Drop *e* from the tier (lock held). Below this tier there is
        only the source — the bytes really vanish. Pinned entries recycle
        their file slot on the last unpin."""
        self._lru.pop(id(e), None)
        entries = self._index.get(e.skey)
        if entries is not None:
            i = bisect.bisect_right(entries, e.lo, key=lambda x: x.lo) - 1
            if 0 <= i < len(entries) and entries[i] is e:
                entries.pop(i)
            if not entries:
                del self._index[e.skey]
        self.evictions += 1
        if e.refs == 0:
            self._release_slot_locked(e)
        else:
            e.dead = True  # last unpin releases the slot

    # -- demote (HotCache eviction hook) ------------------------------------
    def offer(self, skey: Any, lo: int, hi: int, data: np.ndarray, *,
              tenant: "str | None" = None) -> int:
        """Spill bytes [lo, hi) of *skey* (``data`` holds them). Skips
        subranges already spilled (disjointness; source bytes are
        immutable). Returns bytes newly spilled."""
        n = hi - lo
        if n <= 0 or size_class(n) > self.max_bytes or self._closed:
            return 0
        d8 = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        written = 0
        # gap scan under the lock; codec pass OUTSIDE it (CPU never runs
        # under the tier lock); allocation under it; pwrite outside;
        # publish under it again — the allocated slot is private until
        # published, so nothing can read half-written bytes
        with self._lock:
            if self._closed:
                return 0
            entries = self._index.get(skey, ())
            gaps: list[tuple[int, int]] = []
            pos = lo
            i = max(bisect.bisect_right(entries, lo, key=lambda e: e.lo) - 1,
                    0) if entries else 0
            while pos < hi and i < len(entries):
                e = entries[i]
                if e.hi <= pos:
                    i += 1
                    continue
                if e.lo >= hi:
                    break
                if e.lo > pos:
                    gaps.append((pos, e.lo))
                pos = max(pos, e.hi)
                i += 1
            if pos < hi:
                gaps.append((pos, hi))
        codec = self._codec
        # (g_lo, g_hi, payload_u8, codec_name): payload is the raw slice
        # view when compression is off or didn't pay — no copy either way
        prepped: list = []
        for g_lo, g_hi in gaps:
            seg = d8[g_lo - lo: g_hi - lo]
            payload, cname = seg, None
            if codec is not None:
                comp = codec.compress(seg.tobytes())
                if len(comp) < len(seg):
                    payload = np.frombuffer(comp, np.uint8)
                    cname = codec.name
            prepped.append((g_lo, g_hi, payload, cname))
        staged: list = []   # + (off, cls)
        with self._lock:
            if self._closed:
                return 0
            for g_lo, g_hi, payload, cname in prepped:
                off = self._alloc_locked(len(payload), tenant)
                if off is None:
                    continue
                staged.append((g_lo, g_hi, payload, cname, off,
                               size_class(len(payload))))
        for _g_lo, _g_hi, payload, _cname, off, _cls in staged:
            self._pwrite(payload, off)
        if not staged:
            return 0
        comp_in = comp_out = 0
        with self._lock:
            if self._closed:
                return 0
            entries = self._index.setdefault(skey, [])
            for g_lo, g_hi, payload, cname, off, cls in staged:
                e = _SpillEntry(skey, g_lo, g_hi, off, cls, tenant,
                                codec=cname, stored=len(payload))
                i = bisect.bisect_right(entries, g_lo, key=lambda x: x.lo)
                # a concurrent offer may have covered the gap meanwhile;
                # keep entries disjoint (release the orphaned slot)
                prev_ok = i == 0 or entries[i - 1].hi <= g_lo
                next_ok = i == len(entries) or entries[i].lo >= g_hi
                if not (prev_ok and next_ok):
                    self._release_slot_locked(e)
                    continue
                entries.insert(i, e)
                self._lru[id(e)] = e
                written += g_hi - g_lo
                if cname is not None:
                    comp_in += g_hi - g_lo
                    comp_out += len(payload)
            self.spilled_bytes += written
            self.spills += 1 if written else 0
            self.comp_bytes_in += comp_in
            self.comp_bytes_out += comp_out
            ratio = (round(self.comp_bytes_in / self.comp_bytes_out, 4)
                     if self.comp_bytes_out else 0.0)
        if written:
            self._scope.add("spill_spilled_bytes", written)
        if comp_in:
            self._scope.add("spill_comp_bytes_in", comp_in)
            self._scope.add("spill_comp_bytes_out", comp_out)
            self._scope.set_gauge("spill_comp_ratio", ratio)
        return written

    # -- serve ---------------------------------------------------------------
    def lookup(self, skey: Any, lo: int, hi: int, *, record: bool = True
               ) -> tuple[list[tuple[int, int, _SpillEntry]],
                          list[tuple[int, int]]]:
        """Split [lo, hi) of *skey* into spilled and missing ranges.
        Returned entries are PINNED — the caller preads them via
        :meth:`read_into` and MUST :meth:`unpin` afterwards."""
        hits: list[tuple[int, int, _SpillEntry]] = []
        misses: list[tuple[int, int]] = []
        with self._lock:
            entries = self._index.get(skey, ())
            pos = lo
            i = max(bisect.bisect_right(entries, lo, key=lambda e: e.lo) - 1,
                    0) if entries else 0
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
                self._lru.move_to_end(id(e))
                hits.append((s, t, e))
                pos = t
                i += 1
            if pos < hi:
                misses.append((pos, hi))
            if record:
                self.hit_bytes += sum(t - s for s, t, _ in hits)
                self.hits += len(hits)
                self.miss_bytes += sum(t - s for s, t in misses)
                self.misses += len(misses)
        if record and hits:
            self._scope.add("spill_hits", len(hits))
            self._scope.add("spill_hit_bytes",
                            sum(t - s for s, t, _ in hits))
        return hits, misses

    def read_into(self, e: _SpillEntry, s: int, t: int,
                  dest: np.ndarray) -> int:
        """Read spill bytes [s, t) of *e*'s range straight into *dest*
        (writable uint8 view, len >= t-s). Raw entries pread with no
        intermediate copy (engine-routed when a router is attached and can
        enqueue safely, else the buffered fd); compressed entries read
        their stored payload and decompress through it (counted
        ``spill_decomp_bytes``). The entry must be pinned (a
        :meth:`lookup` hit)."""
        n = t - s
        if e.codec is None:
            return self._read_raw(dest, e.off + (s - e.lo), n)
        from strom_torch.utils.codec import get_codec

        comp = np.empty(e.stored, np.uint8)
        self._read_raw(comp, e.off, e.stored)
        codec = get_codec(e.codec)
        if codec is None:  # pragma: no cover - entry codec is process-local
            raise RuntimeError(f"spill entry codec {e.codec!r} unavailable")
        raw = codec.decompress(comp)
        dest[:n] = np.frombuffer(raw, np.uint8, count=n, offset=s - e.lo)
        with self._lock:
            self.decomp_bytes += n
        self._scope.add("spill_decomp_bytes", n)
        return n

    def _read_raw(self, dest: np.ndarray, off: int, n: int) -> int:
        io = self._io
        if io is not None and io.read(dest[:n], off, n):
            with self._lock:
                self.engine_ops += 1
            return n
        with self._lock:
            self.fallback_ops += 1
        return os.preadv(self._fd, [memoryview(dest)[:n]], off)

    def _pwrite(self, data: np.ndarray, off: int) -> None:
        """Spill-file write: engine-routed when safe, buffered fd
        otherwise. Never called under the tier lock (two-phase
        allocate/publish — see module docstring)."""
        io = self._io
        if io is not None and io.write(data, off):
            with self._lock:
                self.engine_ops += 1
            return
        with self._lock:
            self.fallback_ops += 1
        # numpy slices speak the buffer protocol: no bytes() bounce
        os.pwrite(self._fd, data.data, off)

    def note_promote(self, nbytes: int) -> None:
        """Count a readahead-driven spill→RAM promotion (the warm consult
        in strom/delivery/core.py re-admits upcoming-window spill hits)."""
        if nbytes <= 0:
            return
        with self._lock:
            self.promote_bytes += nbytes
        self._scope.add("spill_promote_bytes", nbytes)

    def unpin(self, entries) -> None:
        with self._lock:
            for e in entries:
                e.refs -= 1
                if e.dead and e.refs == 0:
                    self._release_slot_locked(e)
                    e.dead = False

    # -- partitions / lifecycle ----------------------------------------------
    def set_io(self, io) -> None:
        """Attach the engine I/O router (see ``__init__``; the context
        attaches it after construction so registration sees the created
        spill file)."""
        self._io = io

    def set_partition(self, tenant: str, max_bytes: int) -> None:
        """Cap *tenant*'s spill bytes (0 removes the partition)."""
        with self._lock:
            if max_bytes <= 0:
                self._partitions.pop(tenant, None)
            else:
                self._partitions[tenant] = int(max_bytes)

    def partitions(self) -> dict:
        with self._lock:
            return {t: {"max_bytes": m,
                        "bytes": self._tenant_bytes.get(t, 0)}
                    for t, m in self._partitions.items()}

    def invalidate(self, skey: Any) -> int:
        """Drop every spilled range of *skey* — and of any derived tuple
        key embedding it (decoded-frame keys carry the shard path inside a
        tuple) — the source bytes changed."""
        dropped = 0
        with self._lock:
            keys = [k for k in self._index
                    if k == skey or (isinstance(k, tuple) and skey in k)]
            for k in keys:
                for e in list(self._index.get(k, ())):
                    dropped += 1
                    self._evict_locked(e)
        return dropped

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        io, self._io = self._io, None
        if io is not None:
            with contextlib.suppress(Exception):
                io.close()
        os.close(self._fd)
        with contextlib.suppress(OSError):
            os.unlink(self.path)

    # -- introspection -------------------------------------------------------
    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._lru)

    def manifest(self, *, max_entries: int = 4096) -> list[list]:
        """Spilled path-keyed ranges, newest-first, as JSON-stable
        ``[path, lo, hi]`` triples — warm-state hints for a StepToken
        tuple (decoded-frame) keys are skipped like the hot
        cache's manifest."""
        out: list[list] = []
        with self._lock:
            for e in reversed(self._lru.values()):
                if len(out) >= max_entries:
                    break
                if isinstance(e.skey, str):
                    out.append([e.skey, e.lo, e.hi])
        return out

    def stats(self) -> dict:
        """The ``spill`` section of ``StromContext.stats()`` — full metric
        names as keys."""
        with self._lock:
            served = self.hit_bytes + self.miss_bytes
            return {
                "spill_budget_bytes": self.max_bytes,
                "spill_bytes": self.bytes,
                "spill_entries": len(self._lru),
                "spill_hit_bytes": self.hit_bytes,
                "spill_hits": self.hits,
                "spill_miss_bytes": self.miss_bytes,
                "spill_spilled_bytes": self.spilled_bytes,
                "spill_evictions": self.evictions,
                "spill_promote_bytes": self.promote_bytes,
                "spill_engine_ops": self.engine_ops,
                "spill_fallback_ops": self.fallback_ops,
                "spill_comp_bytes_in": self.comp_bytes_in,
                "spill_comp_bytes_out": self.comp_bytes_out,
                "spill_decomp_bytes": self.decomp_bytes,
                "spill_comp_ratio":
                    round(self.comp_bytes_in / self.comp_bytes_out, 4)
                    if self.comp_bytes_out else 0.0,
                "spill_hit_ratio":
                    round(self.hit_bytes / served, 4) if served else 0.0,
            }
