"""Decoded-output cache: predecoded on the fly (the port's copy of
``strom/formats/decoded_cache.py``).

The hot cache (``strom_torch/delivery/hotcache.py``) serves repeat
COMPRESSED bytes from RAM, but a JPEG pipeline still pays the full decode
every epoch. This adapter admits first-epoch decode OUTPUT (full-frame
RGB8, before the crop) into the same :class:`HotCache`, so a later epoch
pays only crop and resize per sample.

- **Keys.** ``("jpegdec", shard_path, member_lo, member_hi, fingerprint)``:
  the member's physical extent, stable across epochs, plus a decode
  fingerprint (decoder and colourspace), so pixels decoded under other
  semantics never serve each other. The byte range within a key is
  ``[0, h*w*3)``, h and w from the member's SOF header.
- **Fidelity.** Cached pixels are full-resolution decodes: a hit gives the
  pixels of the ``reduced_scale=False`` path, bit for bit. The admitting
  pass therefore decodes in full where ROI or reduced decode would have
  engaged.
- **Budget.** Entries ride the hot cache's budget and admission policy
  (second touch observes the first epoch, admits the second).
- **Pinning.** A served frame stays pinned for the crop and resize only;
  the caller releases it.
- **Plan-time probe.** :meth:`DecodedCache.probe` runs before the batch's
  gather: a resident frame skips its image member's read entirely and rides
  to the decode pool as a :class:`ServedFrame`.

Counters (``decode_cache_*``) are kept apart from the extent cache's
``cache_*`` set (lookups run ``record=False``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

import numpy as np
from strom_torch.utils.locks import make_lock
from strom_torch.utils.stats import global_stats

_DIMS_CAP = 1 << 16  # bounded (ckey -> (h, w)) ledger for plan-time probes


class ServedFrame:
    """A decoded frame served from the cache at plan time: the pinned
    full-frame view handed to the decode pool in place of the JPEG bytes
    that were never gathered. The transform (and a failed batch's cleanup)
    release it; release is idempotent."""

    __slots__ = ("img", "_pin", "_dcache")

    def __init__(self, img: np.ndarray, pin, dcache: "DecodedCache"):
        self.img = img
        self._pin = pin
        self._dcache = dcache

    def release(self) -> None:
        self._dcache._release_frame(self)


class DecodedCache:
    """Counter-bearing adapter between the JPEG transform and a
    :class:`~strom_torch.delivery.hotcache.HotCache` holding decoded
    frames. Thread-safe: the tally lock is held only for counter updates,
    never across cache calls."""

    def __init__(self, cache, *, tenant: "str | None" = None,
                 fingerprint: str = "rgb8", scope=None):
        self._hot_cache = cache
        # frames charge this tenant's cache partition (None: shared)
        self._tenant = tenant
        self._fp = fingerprint
        self._lock = make_lock("cache.decoded")
        # the registry mirror of the counts below (the context's decode
        # section and /metrics read it)
        self._scope = scope if scope is not None else global_stats
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.admitted_bytes = 0
        # frame dims per key, learned at offer/get: the plan-time probe has
        # no JPEG header to read h and w from
        self._dims: "OrderedDict[Any, tuple[int, int]]" = OrderedDict()
        self.plan_hits = 0
        self.plan_skipped_bytes = 0

    @property
    def enabled(self) -> bool:
        """Follows the backing cache's gate."""
        return self._hot_cache is not None and self._hot_cache.enabled

    def key(self, path: str, lo: int, hi: int) -> tuple:
        """Cache key of the member at file bytes [lo, hi) of *path*."""
        return ("jpegdec", path, lo, hi, self._fp)

    def get(self, ckey: Any, h: int, w: int):
        """(pinned (h, w, 3) view, pin) on a hit, None on a miss. The
        caller MUST :meth:`release` the pin after the crop and resize."""
        n = h * w * 3
        got = self._hot_cache.view(ckey, 0, n, record=False)
        self._note_dims(ckey, h, w)
        if got is None:
            with self._lock:
                self.misses += 1
            self._scope.add("decode_cache_misses")
            return None
        buf, entry = got
        with self._lock:
            self.hits += 1
            self.hit_bytes += n
        self._scope.add("decode_cache_hits")
        self._scope.add("decode_cache_hit_bytes", n)
        return buf.reshape(h, w, 3), entry

    def _note_dims(self, ckey: Any, h: int, w: int) -> None:
        with self._lock:
            self._dims[ckey] = (h, w)
            self._dims.move_to_end(ckey)
            while len(self._dims) > _DIMS_CAP:
                self._dims.popitem(last=False)

    def probe(self, ckey: Any, skipped_bytes: int = 0
              ) -> "ServedFrame | None":
        """A pinned :class:`ServedFrame` when the full frame for *ckey* is
        resident: the caller then gathers no image member and hands the
        frame to the transform. None when the frame or its dims are absent
        (a stale ledger costs a wasted gather, never wrong pixels).
        *skipped_bytes*, the member size the hit avoids reading, is
        counted."""
        if not self.enabled:
            return None
        with self._lock:
            dims = self._dims.get(ckey)
        if dims is None:
            return None
        h, w = dims
        got = self._hot_cache.view(ckey, 0, h * w * 3, record=False)
        if got is None:
            return None
        buf, entry = got
        with self._lock:
            self.hits += 1
            self.hit_bytes += h * w * 3
            self.plan_hits += 1
            self.plan_skipped_bytes += skipped_bytes
        self._scope.add("decode_cache_hits")
        self._scope.add("decode_cache_hit_bytes", h * w * 3)
        self._scope.add("decode_cache_plan_hits")
        return ServedFrame(buf.reshape(h, w, 3), entry, self)

    def export(self, path: str, lo: int, hi: int,
               fingerprint: "str | None" = None
               ) -> "tuple[int, int, bytes] | None":
        """The peer server's lookup: ``(h, w, rgb bytes)`` for the member
        at [*lo*, *hi*) of *path* when its whole decoded frame is resident,
        else None. Unlike :meth:`probe` the pixels are copied out (the
        server writes them to a socket after the call returns, outside any
        pin), and the asker's decode *fingerprint* must equal ours: pixels
        decoded under other semantics never cross the wire."""
        if not self.enabled:
            return None
        if fingerprint and fingerprint != self._fp:
            return None
        ckey = ("jpegdec", path, lo, hi, self._fp)
        with self._lock:
            dims = self._dims.get(ckey)
        if dims is None:
            return None
        h, w = dims
        got = self._hot_cache.view(ckey, 0, h * w * 3, record=False)
        if got is None:
            return None
        buf, entry = got
        try:
            out = bytes(buf)
        finally:
            self._hot_cache.unpin((entry,))
        with self._lock:
            self.hits += 1
            self.hit_bytes += h * w * 3
        self._scope.add("decode_cache_hits")
        self._scope.add("decode_cache_hit_bytes", h * w * 3)
        return h, w, out

    def release(self, pin) -> None:
        self._hot_cache.unpin((pin,))

    def _release_frame(self, frame: ServedFrame) -> None:
        """Idempotent ServedFrame release: the pin drops exactly once."""
        with self._lock:
            pin, frame._pin = frame._pin, None
        if pin is not None:
            self._hot_cache.unpin((pin,))

    def offer(self, ckey: Any, img: np.ndarray) -> int:
        """Offer a decoded full frame for admission (the cache's policy,
        budget and the owning tenant's partition decide). Returns bytes
        admitted (0: refused or already resident)."""
        if img.ndim == 3:
            self._note_dims(ckey, img.shape[0], img.shape[1])
        flat = np.ascontiguousarray(img).reshape(-1)
        admitted = self._hot_cache.admit(ckey, 0, flat.size, flat,
                                         tenant=self._tenant)
        if admitted:
            with self._lock:
                self.admitted_bytes += admitted
            self._scope.add("decode_cache_admitted_bytes", admitted)
        return admitted

    def stats(self) -> dict:
        """This cache's own counts (the context's ``decode`` section reads
        their registry mirror)."""
        with self._lock:
            return {"decode_cache_hits": self.hits,
                    "decode_cache_misses": self.misses,
                    "decode_cache_hit_bytes": self.hit_bytes,
                    "decode_cache_admitted_bytes": self.admitted_bytes,
                    "decode_cache_plan_hits": self.plan_hits,
                    "decode_cache_plan_skipped_bytes":
                        self.plan_skipped_bytes}
