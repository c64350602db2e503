"""JPEG host decode and ImageNet-style transforms (the port's copy of
``strom/formats/jpeg.py``).

The engine lands compressed bytes in host memory; decode runs on a thread
pool (cv2 and the native binding release the GIL, so threads scale) and the
decoded uint8 rows are what the pipeline copies to the card. Consumer: the
vision pipelines.

- **Reduced-scale decode**: when the sampled crop still covers the target
  at 1/d (d in 2, 4, 8; the encoded dims come from the SOF header, no
  decode), decode at 1/d. The crop is sampled in full-resolution
  coordinates before d is chosen, so the random stream is the same either
  way.
- **Direct-to-slot decode**: every transform takes an ``out=`` row of the
  batch array, so the resize writes its pixels straight into the batch.
- **Per-sample failure policy** (slot path): a ``ValueError`` from decode
  zeroes the row and counts ``decode_errors`` instead of failing the batch.
- **Native libjpeg-turbo binding**: ``sc_jpeg_decode`` in the port's native
  library, built only where the build probe finds libjpeg-turbo
  (``strom_torch/_core/build.py``). One C call decodes straight to RGB,
  bit-exact against cv2 for full and reduced decode; with ROI, only the
  crop's scanlines and iMCU columns are decoded (never for progressive
  members, where the partial-scanline API gives wrong pixels).
- **Fused runs**: :meth:`DecodePool.submit_run_into` decodes a run of
  samples per pool task; the run length tunes itself from a per-image
  decode-time average.
- **Decoded-output cache**: with a ``DecodedCache``
  (``formats/decoded_cache.py``) and a per-sample key, the full decoded
  frame is served from or offered to the hot cache, so a repeat epoch pays
  only crop and resize; a frame found at plan time arrives as a
  ``ServedFrame`` in place of the member bytes.

``cv2`` and ``PIL`` are optional: decode and resize use cv2 where it
imports, else PIL, else raise.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import os
import threading
import time
from typing import Callable, Iterable, NamedTuple, Sequence

import numpy as np

from strom_torch.formats.decoded_cache import ServedFrame
from strom_torch.obs import request as _request
from strom_torch.obs.events import ring as _events_ring
from strom_torch.utils.locks import make_lock
from strom_torch.utils.stats import global_stats

try:
    import cv2

    _HAVE_CV2 = True
# a capability probe: cv2 can fail with other errors than ImportError
# (a missing libGL raises OSError); the flag is the outcome either way
except Exception:  # pragma: no cover - depends on the machine
    _HAVE_CV2 = False

try:
    from PIL import Image
    import io

    _HAVE_PIL = True
# a capability probe, as for cv2 above
except Exception:  # pragma: no cover
    _HAVE_PIL = False


# DecodeCounts keys and the registry series they mirror into (the
# reference's names); other keys mirror under their own
_REGISTRY_NAMES = {"native_imgs": "decode_native_imgs",
                   "native_fallbacks": "decode_native_fallbacks",
                   "roi_hits": "decode_roi_hits",
                   "roi_rows_skipped": "decode_roi_rows_skipped",
                   "reduced_hits_2": "decode_reduced_hits_2",
                   "reduced_hits_4": "decode_reduced_hits_4",
                   "reduced_hits_8": "decode_reduced_hits_8"}


class DecodeCounts:
    """Thread-safe counters of the routes decode took (``native_imgs``,
    ``native_fallbacks``, ``roi_hits``, ``reduced_hits_<d>``, ...), one
    pipeline's, each mirrored into the process-wide registry."""

    def __init__(self) -> None:
        self._c: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[key] += n
        global_stats.add(_REGISTRY_NAMES.get(key, key), n)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


# -- SOF header parsing (no decode) -----------------------------------------

# SOF0..SOF15 carry frame dimensions, except DHT (C4), JPG (C8), DAC (CC)
_SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# the multi-scan (progressive) subset: the partial-scanline API gives wrong
# pixels on these, so they take the full decode
_PROGRESSIVE_MARKERS = frozenset({0xC2, 0xC6, 0xCA, 0xCE})


class JpegInfo(NamedTuple):
    """SOF frame header facts: dimensions and the progressive flag."""

    h: int
    w: int
    progressive: bool


def parse_jpeg_info(data: bytes | np.ndarray) -> JpegInfo | None:
    """Frame dims + progressive flag from a JPEG's SOF header, walking
    marker segments only. None for anything that is not parseable JPEG
    (PNG members, truncated headers): callers take the full decode path,
    which raises its own error."""
    if isinstance(data, np.ndarray):
        b = data.view(np.uint8).reshape(-1)
    else:
        b = np.frombuffer(data, dtype=np.uint8)
    n = b.shape[0]
    if n < 4 or b[0] != 0xFF or b[1] != 0xD8:
        return None
    i = 2
    while i + 3 < n:
        if b[i] != 0xFF:
            return None  # desynced: not walking marker segments anymore
        marker = int(b[i + 1])
        if marker == 0xFF:  # fill byte before a marker
            i += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # standalone TEM/RSTn
            i += 2
            continue
        if marker in (0xD9, 0xDA):  # EOI / SOS before any SOF: give up
            return None
        seg_len = (int(b[i + 2]) << 8) | int(b[i + 3])
        if seg_len < 2:
            return None
        if marker in _SOF_MARKERS:
            if i + 9 > n:
                return None
            h = (int(b[i + 5]) << 8) | int(b[i + 6])
            w = (int(b[i + 7]) << 8) | int(b[i + 8])
            if h <= 0 or w <= 0:
                return None
            return JpegInfo(h, w, marker in _PROGRESSIVE_MARKERS)
        i += 2 + seg_len
    return None


def parse_jpeg_dims(data: bytes | np.ndarray) -> tuple[int, int] | None:
    """(height, width) from a JPEG's SOF header."""
    info = parse_jpeg_info(data)
    return None if info is None else (info.h, info.w)


def reduced_denom(h: int, w: int, size: int) -> int:
    """Largest decode denominator d in (8, 4, 2) at which an (h, w) crop
    still covers the size×size target: min(h, w) >= size * d. Callers pass
    the crop's dims: a reduced crop below the target would be upscaled
    where the full path downsamples. 1 = full scale."""
    if size <= 0:
        return 1
    shorter = min(h, w)
    for d in (8, 4, 2):
        if shorter >= size * d:
            return d
    return 1


# -- native libjpeg-turbo binding --------------------------------------------

_native_lock = threading.Lock()
_NATIVE_UNRESOLVED = object()
_native_decode: "Callable | None | object" = _NATIVE_UNRESOLVED


def _resolve_native() -> "Callable | None":
    """The native decode callable, or None where the library was built
    without libjpeg-turbo (or did not build). Resolved at first call, never
    at import."""
    global _native_decode
    with _native_lock:
        if _native_decode is not _NATIVE_UNRESOLVED:
            return _native_decode  # type: ignore[return-value]
        fn: "Callable | None" = None
        try:
            from strom_torch._core.build import ensure_built

            lib = ctypes.CDLL(ensure_built())
        except (RuntimeError, OSError):
            lib = None   # no compiler or no loadable library: no native path
        if lib is not None and lib.sc_jpeg_available() == 1:
            lib.sc_jpeg_decode.restype = ctypes.c_int
            lib.sc_jpeg_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]

            def fn(data, *, reduced=1, roi=None, out=None,  # type: ignore[misc]
                   _lib=lib):
                return _decode_native_call(_lib, data, reduced=reduced,
                                           roi=roi, out=out)
        _native_decode = fn
        return fn


def native_available() -> bool:
    """True when the native decode binding is live."""
    return _resolve_native() is not None


# horizontal widening for ROI decodes: fancy upsampling lacks context at
# the iMCU-aligned boundary jpeg_crop_scanline grants, so 2 extra columns
# each side keep the returned rect strictly interior, where partial decode
# is bit-exact against full
_ROI_X_MARGIN = 2


def _decode_native_call(lib, data, *, reduced: int = 1,
                        roi: "tuple[int, int, int, int] | None" = None,
                        out: "np.ndarray | None" = None) -> np.ndarray:
    """ctypes shim over ``sc_jpeg_decode``. With *roi* = (y, x, h, w) in
    scaled (post-*reduced*) coordinates, decodes only the crop and returns
    exactly that (h, w, 3) rect; without, the full scaled frame, into *out*
    when given. Raises ValueError on anything undecodable, as
    :func:`decode_jpeg` does."""
    buf = np.frombuffer(data, dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray, memoryview)) \
        else data.view(np.uint8).reshape(-1)
    if not buf.flags.c_contiguous:
        buf = np.ascontiguousarray(buf)
    info = parse_jpeg_info(buf)
    if info is None:
        raise ValueError("not a decodable image")
    oh, ow = -(-info.h // reduced), -(-info.w // reduced)
    got = (ctypes.c_int32 * 4)()
    if roi is None:
        dst = out
        if dst is None:
            dst = np.empty((oh, ow, 3), dtype=np.uint8)
        elif dst.shape != (oh, ow, 3) or dst.dtype != np.uint8 \
                or not dst.flags.c_contiguous:
            raise ValueError("out must be a C-contiguous uint8 array of "
                             f"shape {(oh, ow, 3)}")
        rc = lib.sc_jpeg_decode(buf.ctypes.data, buf.size, dst.ctypes.data,
                                dst.nbytes, ow * 3, reduced,
                                0, 0, 0, 0, got)
        if rc != 0 or (got[0], got[1]) != (oh, ow):
            raise ValueError(f"native jpeg decode failed (rc={rc})")
        return dst
    y, x, h, w = roi
    if not (0 <= y and 0 <= x and h > 0 and w > 0
            and y + h <= oh and x + w <= ow):
        raise ValueError(f"roi {roi} outside scaled frame {(oh, ow)}")
    rx = max(x - _ROI_X_MARGIN, 0)
    rw = min(x + w + _ROI_X_MARGIN, ow) - rx
    # the granted width exceeds the request by at most one iMCU each side
    # (32 px at h_samp_factor 4): budget 64 extra columns; rows pack at the
    # granted width and the C side rejects anything wider
    flat = np.empty(h * (rw + 64) * 3, dtype=np.uint8)
    rc = lib.sc_jpeg_decode(buf.ctypes.data, buf.size, flat.ctypes.data,
                            flat.nbytes, 0, reduced, y, rx, h, rw, got)
    if rc != 0:
        raise ValueError(f"native jpeg roi decode failed (rc={rc})")
    gh, gw, gx0, _ = got
    img = flat[: gh * gw * 3].reshape(gh, gw, 3)
    return img[:, x - gx0: x - gx0 + w]


def decode_jpeg(data: bytes | np.ndarray, *, reduced: int = 1) -> np.ndarray:
    """Decode JPEG/PNG bytes → HWC uint8 RGB array; *reduced* in (2, 4, 8)
    decodes JPEGs at 1/reduced scale."""
    if _HAVE_CV2:
        flag = {1: cv2.IMREAD_COLOR,
                2: cv2.IMREAD_REDUCED_COLOR_2,
                4: cv2.IMREAD_REDUCED_COLOR_4,
                8: cv2.IMREAD_REDUCED_COLOR_8}[reduced]
        buf = np.frombuffer(data, dtype=np.uint8) \
            if isinstance(data, (bytes, memoryview)) \
            else data.view(np.uint8).reshape(-1)
        img = cv2.imdecode(buf, flag)
        if img is None:
            raise ValueError("not a decodable image")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if _HAVE_PIL:
        raw = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
        try:
            with Image.open(io.BytesIO(raw)) as im:
                if reduced > 1:
                    # draft mode: JPEG power-of-2 reduced decode
                    im.draft("RGB", (max(1, im.width // reduced),
                                     max(1, im.height // reduced)))
                return np.asarray(im.convert("RGB"))
        except Exception as e:  # UnidentifiedImageError etc.: one contract
            raise ValueError("not a decodable image") from e
    raise RuntimeError("no JPEG decoder available (need cv2 or PIL)")


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if _HAVE_CV2:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    if _HAVE_PIL:
        return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    raise RuntimeError("no image resize available (need cv2 or PIL)")


def _resize_into(img: np.ndarray, size: int,
                 out: np.ndarray | None) -> np.ndarray:
    """Bilinear resize to size x size, into *out* when given."""
    if out is None:
        return _resize(img, size, size)
    if _HAVE_CV2:
        cv2.resize(img, (size, size), dst=out,
                   interpolation=cv2.INTER_LINEAR)
    else:
        out[:] = _resize(img, size, size)
    return out


def _flip_h(dst: np.ndarray, out: np.ndarray | None) -> np.ndarray:
    """Horizontal flip: in place on the slot path, a fresh contiguous
    mirror otherwise; values identical."""
    if out is None:
        return np.ascontiguousarray(dst[:, ::-1])
    if _HAVE_CV2:
        cv2.flip(dst, 1, dst=dst)
    else:
        dst[:] = dst[:, ::-1].copy()
    return dst


def center_crop_resize(img: np.ndarray, size: int,
                       *, resize_shorter: int | None = None) -> np.ndarray:
    """Eval transform: resize shorter side (default size*1.15), center crop."""
    shorter = resize_shorter or int(size * 1.15)
    h, w = img.shape[:2]
    scale = shorter / min(h, w)
    img = _resize(img, max(size, round(h * scale)), max(size, round(w * scale)))
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top: top + size, left: left + size]


def sample_rrc_geometry(h: int, w: int, rng: np.random.Generator,
                        *, scale: tuple[float, float] = (0.08, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3)
                        ) -> tuple[int, int, int, int]:
    """(top, left, crop_h, crop_w) of an Inception-style random area/aspect
    crop in (h, w) coordinates; falls back to the center square. The full
    and reduced decode paths both sample here in full resolution, so their
    random streams are identical."""
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = round(np.sqrt(target * ar))
        ch = round(np.sqrt(target / ar))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    side = min(h, w)
    return (h - side) // 2, (w - side) // 2, side, side


def random_resized_crop(img: np.ndarray, size: int, rng: np.random.Generator,
                        *, scale: tuple[float, float] = (0.08, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3),
                        out: np.ndarray | None = None) -> np.ndarray:
    """Train transform: random area/aspect crop → size×size, then a
    horizontal flip coin. With *out*, the result lands in that row."""
    h, w = img.shape[:2]
    top, left, ch, cw = sample_rrc_geometry(h, w, rng, scale=scale,
                                            ratio=ratio)
    dst = _resize_into(img[top: top + ch, left: left + cw], size, out)
    if rng.random() < 0.5:
        return _flip_h(dst, out)
    return np.ascontiguousarray(dst) if out is None else dst


def _scale_crop(top: int, left: int, ch: int, cw: int,
                fh: int, fw: int, rh: int, rw: int
                ) -> tuple[int, int, int, int]:
    """Map a full-resolution crop rectangle onto a reduced decode of shape
    (rh, rw) (libjpeg's reduced sizes are ceil(dim/d), so the ratio comes
    from the decoded shape, not the nominal d). Clamped non-empty."""
    sy, sx = rh / fh, rw / fw
    r0 = min(int(round(top * sy)), rh - 1)
    c0 = min(int(round(left * sx)), rw - 1)
    r1 = max(r0 + 1, min(int(round((top + ch) * sy)), rh))
    c1 = max(c0 + 1, min(int(round((left + cw) * sx)), rw))
    return r0, c0, r1 - r0, c1 - c0


def make_train_transform(size: int, *, reduced_scale: bool = True,
                         scale: tuple[float, float] = (0.08, 1.0),
                         ratio: tuple[float, float] = (3 / 4, 4 / 3),
                         native: bool = True,
                         roi: bool = True,
                         counts: DecodeCounts | None = None,
                         dcache=None) -> Callable[..., np.ndarray]:
    """Transform(jpeg_bytes, rng, out=None, ckey=None) -> size×size×3 uint8.

    With *reduced_scale*, the crop is sampled first (full-resolution
    coordinates, from the SOF header), then the largest denominator at
    which the crop still covers the target is chosen and the rectangle is
    mapped onto the reduced image. Non-JPEG members take the full path.
    With *native* (and the binding built), decode runs through the native
    library, falling back to cv2/PIL per sample on a native error; with
    *roi* as well, only the crop is decoded. *counts* records the route
    each sample took. With *dcache* (a ``DecodedCache``) and a *ckey*, the
    FULL decoded frame is served from or offered to the hot cache: a hit
    gives the pixels of the ``reduced_scale=False`` path, bit for bit, and
    costs only the crop and resize. *data* may be a ``ServedFrame`` (a
    plan-time hit), which the transform releases."""
    note = counts.add if counts is not None else (lambda key, n=1: None)

    def tf(data, rng: np.random.Generator,
           out: np.ndarray | None = None, ckey=None) -> np.ndarray:
        if isinstance(data, ServedFrame):
            # a plan-time hit: the member was never gathered. The same
            # random draws as every other path (geometry, then one flip)
            img = data.img
            try:
                fh, fw = img.shape[:2]
                top, left, ch, cw = sample_rrc_geometry(
                    fh, fw, rng, scale=scale, ratio=ratio)
                dst = _resize_into(img[top: top + ch, left: left + cw],
                                   size, out)
            finally:
                data.release()
            note("frames_from_cache")
            if rng.random() < 0.5:
                return _flip_h(dst, out)
            return np.ascontiguousarray(dst) if out is None else dst
        info = parse_jpeg_info(data) if (reduced_scale or native
                                         or dcache is not None) else None
        if info is None:
            return random_resized_crop(decode_jpeg(data), size, rng,
                                       scale=scale, ratio=ratio, out=out)
        fh, fw = info.h, info.w
        top, left, ch, cw = sample_rrc_geometry(fh, fw, rng, scale=scale,
                                                ratio=ratio)

        def finish(dst):
            # one flip draw in every path, after the resize: the random
            # stream is the same across full/reduced/native/roi
            if rng.random() < 0.5:
                return _flip_h(dst, out)
            return np.ascontiguousarray(dst) if out is None else dst

        nat = _resolve_native() if native else None
        if dcache is not None and ckey is not None and dcache.enabled:
            # serve the decoded frame from RAM; on a miss decode the FULL
            # frame (no ROI, no reduced scale) and offer it, so a later
            # epoch pays only the crop and resize
            hit = dcache.get(ckey, fh, fw)
            if hit is not None:
                img, pin = hit
                try:
                    dst = _resize_into(img[top: top + ch, left: left + cw],
                                       size, out)
                finally:
                    dcache.release(pin)
                note("frames_from_cache")
                return finish(dst)
            img = None
            if nat is not None:
                try:
                    img = nat(data)
                    note("native_imgs")
                except ValueError:
                    note("native_fallbacks")
            if img is None:
                img = decode_jpeg(data)
                note("cv2_imgs" if _HAVE_CV2 else "pil_imgs")
            dcache.offer(ckey, img)
            return finish(_resize_into(img[top: top + ch, left: left + cw],
                                       size, out))
        denom = reduced_denom(ch, cw, size) if reduced_scale else 1
        if denom == 1:
            rh, rw = fh, fw
            r0, c0, rch, rcw = top, left, ch, cw
        else:
            # libjpeg's reduced sizes are ceil(dim/d): known before decode,
            # so the ROI path can plan scaled coordinates up front
            rh, rw = -(-fh // denom), -(-fw // denom)
            r0, c0, rch, rcw = _scale_crop(top, left, ch, cw, fh, fw,
                                           rh, rw)
        img = None
        if nat is not None:
            # ROI only where partial decode skips work, never progressive
            roi_ok = roi and not info.progressive \
                and (rch < rh or rcw < rw)
            try:
                if roi_ok:
                    rect = nat(data, reduced=denom, roi=(r0, c0, rch, rcw))
                    note("native_imgs")
                    note("roi_hits")
                    # the scaled frame's rows the partial decode skipped
                    note("roi_rows_skipped", rh - rch)
                    if denom > 1:
                        note(f"reduced_hits_{denom}")
                    return finish(_resize_into(rect, size, out))
                img = nat(data, reduced=denom)
                note("native_imgs")
            except ValueError:
                # per-sample fallback: a member the native path rejects
                # takes cv2/PIL, counted so "native silently off" shows
                note("native_fallbacks")
                img = None
        if img is None:
            img = decode_jpeg(data, reduced=denom)
            note("cv2_imgs" if _HAVE_CV2 else "pil_imgs")
        if denom > 1:
            note(f"reduced_hits_{denom}")
        dst = _resize_into(img[r0: r0 + rch, c0: c0 + rcw], size, out)
        return finish(dst)

    return tf


class DecodePool:
    """Thread pool mapping decode+transform over batches of member payloads.

    Workers are clamped to the host's core count (decode has no I/O waits
    to hide). cv2's own threading is off while a pool lives; its prior
    thread count is restored in :meth:`close`.

    Fused runs (*fuse_runs*): one pool task decodes a run of samples; the
    run length tunes itself from a per-image decode-time average against a
    fixed per-task work target, capped so every worker sees at least 2 runs
    per batch. ``fuse_runs=False`` keeps one task per sample.
    """

    # per-task decode-work target: per-task overhead amortizes below ~2%,
    # runs stay short enough not to serialize a batch's tail
    _RUN_TARGET_US = 4000.0

    def __init__(self, workers: int = 8, *, fuse_runs: bool = True):
        self._cv2_threads_prev: int | None = None
        if _HAVE_CV2:
            self._cv2_threads_prev = cv2.getNumThreads()
            cv2.setNumThreads(0)
        workers = max(1, min(workers, os.cpu_count() or workers))
        self.workers = workers
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="strom-decode")
        self.decode_errors = 0
        self._err_lock = make_lock("app.jpeg_errs")
        self.fuse_runs = fuse_runs
        # the live per-task work target: per instance, so the autotuner's
        # decode_run_target_us knob steers a running pool's run length
        self.run_target_us = float(self._RUN_TARGET_US)
        # average per-image decode+transform micros, seeded at 1 ms;
        # updated by fused runs
        self._img_us = 1000.0
        self._closed = False

    def run_size(self, n: int) -> int:
        """Fused-run length for an *n*-sample batch (1 = no fusing)."""
        if not self.fuse_runs or n <= 1:
            return 1
        with self._err_lock:
            per_img = self._img_us
        want = int(self.run_target_us / max(per_img, 1.0))
        cap = -(-n // (self.workers * 2))
        return max(1, min(want, cap))

    @staticmethod
    def _worker_span(req):
        """The per-sample ``decode.worker`` span: on the submitter's request
        lane when it was inside a traced request (*req* is taken at submit
        time: a worker thread has no request of its own), else a plain
        ring span; None when the ring is off (no span object at all)."""
        if req is not None:
            return req.span("decode.worker", cat="decode")
        if not _events_ring.enabled:
            return None
        return _events_ring.span("decode.worker", cat="decode")

    def map(self, fn: Callable[..., np.ndarray],
            items: Iterable, *extra: Sequence) -> list[np.ndarray]:
        req = _request.current()

        def traced(*a) -> np.ndarray:
            cm = self._worker_span(req)
            if cm is None:
                return fn(*a)
            with cm:
                return fn(*a)

        return list(self._pool.map(traced, items, *extra))

    # -- direct-to-slot mapping --------------------------------------------
    def _call(self, fn: Callable[..., np.ndarray], item, rng,
              row: np.ndarray, ckey) -> None:
        if ckey is None:
            fn(item, rng, out=row)
        else:
            fn(item, rng, out=row, ckey=ckey)

    def _one_sample(self, fn: Callable[..., np.ndarray], item, rng,
                    row: np.ndarray, ckey=None, req=None) -> None:
        try:
            cm = self._worker_span(req)
            if cm is None:
                self._call(fn, item, rng, row, ckey)
            else:
                with cm:
                    self._call(fn, item, rng, row, ckey)
        except ValueError:
            # per-sample failure policy: a truncated/corrupt member costs
            # one zero image and a counter bump, not the whole batch
            row[...] = 0
            with self._err_lock:
                self.decode_errors += 1
            global_stats.add("decode_errors")

    def _run_into(self, fn: Callable[..., np.ndarray], items: Sequence,
                  rngs: Sequence, rows: Sequence, ckeys=None,
                  req=None) -> None:
        """One pool task decoding a run of samples; feeds the per-image
        average :meth:`run_size` tunes from."""
        t0 = time.perf_counter()
        for i, (item, rng, row) in enumerate(zip(items, rngs, rows)):
            self._one_sample(fn, item, rng, row,
                             None if ckeys is None else ckeys[i], req)
        n = len(items)
        per_img = (time.perf_counter() - t0) * 1e6 / max(n, 1)
        with self._err_lock:
            self._img_us += 0.2 * (per_img - self._img_us)
        if n > 1:
            global_stats.add("decode_fused_runs")
            global_stats.add("decode_fused_samples", n)

    def submit_into(self, fn: Callable[..., np.ndarray], item, rng,
                    row: np.ndarray, ckey=None) -> concurrent.futures.Future:
        """One decode+transform job writing its result into *row*
        (*ckey*: the sample's decoded-cache key, passed to *fn*)."""
        return self._pool.submit(self._one_sample, fn, item, rng, row, ckey,
                                 _request.current())

    def submit_run_into(self, fn: Callable[..., np.ndarray],
                        items: Sequence, rngs: Sequence, rows: Sequence,
                        ckeys: "Sequence | None" = None
                        ) -> concurrent.futures.Future:
        """A fused run: one pool task decoding items[i] into rows[i]."""
        return self._pool.submit(self._run_into, fn, items, rngs, rows, ckeys,
                                 _request.current())

    def map_into(self, fn: Callable[..., np.ndarray], items: Sequence,
                 rngs: Sequence, out: np.ndarray,
                 ckeys: "Sequence | None" = None) -> np.ndarray:
        """Map fn(item, rng, out=out[i]) over the batch, every worker
        writing straight into its row; contiguous runs fuse into one task
        each per :meth:`run_size`. Returns *out*."""
        n = len(items)
        run = self.run_size(n)
        if run <= 1:
            futs = [self.submit_into(fn, item, rng, out[i],
                                     None if ckeys is None else ckeys[i])
                    for i, (item, rng) in enumerate(zip(items, rngs))]
        else:
            futs = [self.submit_run_into(
                        fn, items[i: i + run], rngs[i: i + run],
                        [out[j] for j in range(i, min(i + run, n))],
                        None if ckeys is None else ckeys[i: i + run])
                    for i in range(0, n, run)]
        # every job done before any error surfaces: none may still write
        # into *out* when the caller reacts
        concurrent.futures.wait(futs)
        for f in futs:
            f.result()
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True)
        if _HAVE_CV2 and self._cv2_threads_prev is not None:
            cv2.setNumThreads(self._cv2_threads_prev)

    def __enter__(self) -> "DecodePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
