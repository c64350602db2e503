"""Vision pipelines over WebDataset and predecoded shards: ImageNet →
ResNet-50 (BASELINE config #2), single device (the port's counterpart of
``strom/pipelines/vision.py``, with ``device=`` in place of ``sharding=``,
so a batch is one row group and one host-to-device copy).

Per JPEG batch: gather the samples' members with the engine, decode and
augment them on the host decode pool straight into the batch slot (a
pinned slab from the context's pool on a CUDA target), copy the slot to the
card. With ``stream_intra_batch`` (the default) the gather is
completion-driven: each sample goes to the decode pool the moment its
extents land, so read and decode overlap within the batch. Batches are
bit-identical either way.

The predecoded pipeline is a pure engine gather and one copy per batch: no
decoder on the host at all.

With the hot cache on (``hot_cache_bytes``), both pipelines warm the
sampler's upcoming batches into it from a readahead thread
(``readahead_window_batches``), and the JPEG pipeline can keep decoded
frames there too (``decode_cache``): a frame found at plan time skips its
member's read and its decode, leaving crop and resize.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import inspect
import queue as _queue
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from strom_torch.delivery.core import (StromContext, resolve_device,
                                       source_size)
from strom_torch.delivery.extents import ExtentList
from strom_torch.delivery.shard import Segment
from strom_torch.formats import jpeg
from strom_torch.formats.decoded_cache import DecodedCache
from strom_torch.formats.jpeg import (DecodeCounts, DecodePool,
                                      make_train_transform)
from strom_torch.formats.predecoded import PredecodedShardSet
from strom_torch.formats.wds import WdsShardSet
from strom_torch.pipelines.base import (Pipeline, _auto_depth_bounds,
                                        resolve_state)
from strom_torch.pipelines.sampler import EpochShuffleSampler, SamplerState

# transform(jpeg_bytes, rng[, out=row]) -> HWC uint8; transforms accepting
# an `out=` keyword get direct-to-slot decode (see make_train_transform)
Transform = Callable[..., np.ndarray]


def _make_readahead(ctx: StromContext, sampler: EpochShuffleSampler,
                    extents_for_batch: Callable[[np.ndarray], ExtentList],
                    tenant: str | None = None):
    """Epoch-aware readahead for a vision pipeline: a background thread
    that maps the sampler's upcoming-batch window (``peek`` crosses the
    epoch boundary) to ExtentLists and warms their cache misses through
    ``ctx.warm``, which yields to demand gathers; what it admits charges
    *tenant*'s cache partition. None when the hot cache or the readahead
    window is off."""
    if ctx.hot_cache is None or ctx.config.readahead_window_batches <= 0:
        return None
    from strom_torch.delivery.hotcache import Readahead

    def window(n: int):
        out = []
        for indices in sampler.peek(max(int(n), 0)):
            el = extents_for_batch(indices)
            if el.size:
                out.append((el, [Segment(0, 0, el.size)], 0))
        return out

    return Readahead(ctx, window, tenant=tenant,
                     window_batches=ctx.config.readahead_window_batches)


def _chain_close(*closers) -> Callable[[], None] | None:
    """One on_close running every non-None closer in order (readahead stops
    before the decode pool)."""
    live = [c for c in closers if c is not None]
    if not live:
        return None

    def close() -> None:
        for c in live:
            c()

    return close


def _decode_put_overlapped(pool: DecodePool, tf: Transform, blobs: Sequence,
                           rngs: Sequence, images: np.ndarray,
                           put: Callable[[np.ndarray], Any],
                           ckeys: "Sequence | None" = None) -> Any:
    """Decode every row into its slot and put the batch the moment the last
    row finishes (completion-ordered; with one device the batch is one row
    group). Contiguous rows fuse into one pool task per ``pool.run_size``.
    Every job has finished before an error surfaces."""
    n = images.shape[0]
    run = pool.run_size(n)
    if run <= 1:
        futs = [pool.submit_into(tf, blobs[i], rngs[i], images[i],
                                 None if ckeys is None else ckeys[i])
                for i in range(n)]
    else:
        futs = [pool.submit_run_into(tf, blobs[i: i + run], rngs[i: i + run],
                                     [images[j] for j in
                                      range(i, min(i + run, n))],
                                     None if ckeys is None
                                     else ckeys[i: i + run])
                for i in range(0, n, run)]
    try:
        for f in concurrent.futures.as_completed(futs):
            f.result()  # decode ValueErrors are absorbed per row by the
            # pool; anything else (a transform bug) aborts the batch
    except BaseException:
        concurrent.futures.wait(futs)
        raise
    return put(images)


def _decode_put_streamed(ctx: StromContext, pool: DecodePool, tf: Transform,
                         el, sizes: Sequence[tuple[int, int]],
                         rngs: Sequence, images: np.ndarray,
                         put: Callable[[np.ndarray], Any],
                         counts: DecodeCounts,
                         ckeys: "Sequence | None" = None,
                         served: "Sequence | None" = None,
                         tenant: str | None = None
                         ) -> tuple[Any, list[int]]:
    """Completion-driven batch assembly: the member gather goes through
    ``ctx.stream_segments`` and each sample goes to the decode pool the
    moment its extents land; the batch is put when its last row decodes.

    *sizes* is ``[(image_bytes, label_bytes)]`` per row, in the order *el*
    concatenates them; a row *served* from the decoded cache at plan time
    has image_bytes 0 and decodes from its ``ServedFrame``. Returns
    ``(put(images), labels)``, the same contents as the barrier path:
    decode order differs, bytes do not.

    A pump thread drives the gather (poll → per-sample byte countdown →
    decode submit), so the engine's queue refills at read pace; decode
    completions come back to this thread over a queue."""
    n = images.shape[0]
    starts: list[int] = []
    ends: list[int] = []
    pos = 0
    for isz, lsz in sizes:
        starts.append(pos)
        pos += isz + lsz
        ends.append(pos)
    remaining = [e - s for s, e in zip(starts, ends)]
    labels: list[int] = [0] * n
    buf = ctx.alloc_read_buffer(el, max(el.size, 1))
    events: _queue.SimpleQueue = _queue.SimpleQueue()
    stop = threading.Event()
    futs: list[concurrent.futures.Future] = []
    futs_lock = threading.Lock()
    g = ctx.stream_segments(el, [Segment(0, 0, el.size)], buf,
                            tenant=tenant)
    counts.add("stream_batches")
    # samples whose extents land together decode together: ready rows are
    # flushed after every poll, in runs of at most run_size
    run = pool.run_size(n)
    ready: list[int] = []

    def mark_ready(i: int) -> None:
        isz, lsz = sizes[i]
        s = starts[i]
        labels[i] = int(buf[s + isz: s + isz + lsz].tobytes() or b"0")
        if not g.done:
            # dispatched while later extents were still in flight
            counts.add("stream_samples_early")
        ready.append(i)

    def blob(i: int):
        if served is not None and served[i] is not None:
            return served[i]
        return buf[starts[i]: starts[i] + sizes[i][0]]

    def flush_ready() -> None:
        while ready:
            grp = tuple(ready[:run])
            del ready[: run]
            if len(grp) == 1:
                i = grp[0]
                f = pool.submit_into(tf, blob(i), rngs[i], images[i],
                                     None if ckeys is None else ckeys[i])
            else:
                f = pool.submit_run_into(
                    tf, [blob(i) for i in grp], [rngs[i] for i in grp],
                    [images[i] for i in grp],
                    None if ckeys is None else [ckeys[i] for i in grp])
            with futs_lock:
                futs.append(f)
            f.add_done_callback(
                lambda fut, g_=grp: events.put(("decoded", g_, fut)))

    def pump() -> None:
        try:
            # rows with no bytes at all have no extent to wait for
            for i in range(n):
                if remaining[i] == 0:
                    mark_ready(i)
            flush_ready()
            while not g.done:
                if stop.is_set():   # the consumer has left: abandon
                    g.close()
                    return
                for lo_b, hi_b in g.poll(min_completions=1, timeout_s=0.05):
                    i = max(bisect.bisect_right(starts, lo_b) - 1, 0)
                    while i < n and starts[i] < hi_b:
                        ov = min(hi_b, ends[i]) - max(lo_b, starts[i])
                        if ov > 0:
                            remaining[i] -= ov
                            if remaining[i] == 0:
                                mark_ready(i)
                        i += 1
                flush_ready()
            g.finish()
            events.put(("done", None))
        except BaseException as e:  # surfaced on the consumer side
            try:
                g.close()
            finally:
                events.put(("error", e))

    pt = threading.Thread(target=pump, name="strom-stream-pump", daemon=True)
    pt.start()
    decoded = 0
    gather_done = False
    err: BaseException | None = None
    try:
        while decoded < n or not gather_done:
            kind, *payload = events.get()
            if kind == "decoded":
                grp, fut = payload
                fut.result()  # per-sample decode errors were absorbed by
                # the pool; anything else aborts the batch
                decoded += len(grp)
            elif kind == "done":
                gather_done = True
            elif kind == "error":
                err = payload[0]
                break
    except BaseException as e:
        err = e
    finally:
        stop.set()
        # bounded: the pump polls in 0.05 s slices, and the gather's
        # watchdog and cancel are bounded by engine_wait_timeout_s
        pt.join()
        if err is not None:
            # decode jobs write into `images` and read `buf`: every one
            # must have finished before the error propagates
            with futs_lock:
                flist = list(futs)
            concurrent.futures.wait(flist)
    if err is not None:
        raise err
    return put(images), labels


def make_wds_vision_pipeline(ctx: StromContext, paths: Sequence[str], *,
                             batch: int,
                             image_size: int,
                             device: Any = None,
                             image_ext: str = "jpg",
                             label_ext: str = "cls",
                             transform: Transform | None = None,
                             decode_workers: int = 8,
                             seed: int = 0,
                             shuffle: bool = True,
                             prefetch_depth: int | None = None,
                             auto_prefetch: bool | None = None,
                             decode_reduced_scale: bool | None = None,
                             decode_to_slot: bool | None = None,
                             decode_overlap_put: bool | None = None,
                             decode_native: bool | None = None,
                             decode_fuse_runs: bool | None = None,
                             decode_roi: bool | None = None,
                             decode_cache: bool | None = None,
                             opgraph: Any = None,
                             opgraph_fuse: bool | None = None,
                             stream_intra_batch: bool | None = None,
                             resume_from: "str | SamplerState | None" = None,
                             scope: dict | None = None
                             ) -> Pipeline:
    """Infinite stream of ``(images [B,S,S,3] uint8, labels [B] int32)``
    tensors (images in the *opgraph*'s output shape and dtype where one is
    given) on *device* (None → the current CUDA device; raises without
    one). The decode knobs default to the context's config.

    Augmentation is deterministic in (seed, batch serial, row): Philox keys
    ``[seed, (serial << 32) + row]``, identical across resume.
    ``pipe.stats()`` reports ``data_stall_steps``, the prefetcher's
    counters, ``decode_errors``, the decode routes taken, the streamed
    counters (``stream_batches``, ``stream_samples_early``), the decoded
    cache's (``decode_cache_*``) and, given one, the *scope* labels under
    ``"scope"``.

    *decode_cache* (needs the context's hot cache and the built-in
    transform) keeps full decoded frames in the hot cache: a frame found
    at plan time skips its member's read and its decode. Cached frames are
    full-resolution, so batches equal the cache-off pipeline's bit for bit
    where that one decodes in full too (``decode_reduced_scale=False``).

    *opgraph*: a :class:`strom_torch.ops.pushdown.OpGraph` compiled once
    against the decoded sample geometry (``(image_size, image_size, 3)``
    uint8) and run on the host between decode and the copy to the device,
    writing the batch slot, which is sized from the graph's output shape and
    dtype; the delivered images take that shape and dtype. With
    *opgraph_fuse* (default on) the graph runs the moment the batch's rows
    have decoded, inside the completion-ordered dispatch (the port's one
    device group is the whole batch); ``opgraph_fuse=False`` is the parity
    reference: barrier decode, then one batch-wise apply. Both give
    bit-identical batches (the kernel is per-sample deterministic). The
    ``ops_*`` counters go to the context's (``ctx.stats()``).

    *scope*: labels of the pipeline's telemetry scope over the context's
    (default ``{"pipeline": "vision"}``); a ``"tenant"`` label routes every
    gather, the readahead's admissions and the decoded cache's frames to
    that tenant (its scheduler queue and cache partition)."""
    device = resolve_device(device)
    ss = WdsShardSet(paths, ctx=ctx)
    if len(ss) < batch:
        raise ValueError(f"dataset has {len(ss)} samples < batch {batch}")
    state, fp = resolve_state(tuple(paths), seed=seed, resume_from=resume_from,
                              ctx=ctx)
    sampler = EpochShuffleSampler(len(ss), batch, seed=seed, shuffle=shuffle,
                                  state=state)
    cfg = ctx.config

    def knob(value: bool | None, default: bool) -> bool:
        return default if value is None else value

    reduced = knob(decode_reduced_scale, cfg.decode_reduced_scale)
    to_slot = knob(decode_to_slot, cfg.decode_to_slot)
    overlap_put = knob(decode_overlap_put, cfg.decode_overlap_put)
    counts = DecodeCounts()
    native = knob(decode_native, cfg.decode_native)
    pscope = ctx.scope.scoped(**(scope if scope is not None
                                 else {"pipeline": "vision"}))
    tname = getattr(pscope, "labels", {}).get("tenant")
    # decoded-output cache: only with a hot cache to admit into, and only
    # for the built-in transform (the ckey keyword is its contract)
    dcache = None
    if knob(decode_cache, cfg.decode_cache) and transform is None \
            and ctx.hot_cache is not None:
        engine = "turbo" if (native and jpeg.native_available()) else "cv2"
        dcache = DecodedCache(ctx.hot_cache, tenant=tname,
                              fingerprint=f"rgb8/{engine}")
        ctx.attach_decoded_cache(dcache)
    tf = transform or make_train_transform(
        image_size, reduced_scale=reduced, native=native,
        roi=knob(decode_roi, cfg.decode_roi), counts=counts, dcache=dcache)
    try:
        tf_out_ok = "out" in inspect.signature(tf).parameters
    except (TypeError, ValueError):  # pragma: no cover - exotic callables
        tf_out_ok = False
    # custom transforms without an out= keyword keep the stack path
    to_slot = to_slot and tf_out_ok
    overlap_put = overlap_put and to_slot
    # the streamed dataflow rides the slot and overlapped-put mechanics
    stream = knob(stream_intra_batch, cfg.stream_intra_batch) and overlap_put
    # the per-sample operator graph, compiled once; unfused, it forces the
    # barrier path, whose one batch-wise apply is the fusion-free reference
    cgraph = None
    if opgraph is not None:
        cgraph = opgraph.compile((image_size, image_size, 3), np.uint8)
        if not knob(opgraph_fuse, True):
            stream = overlap_put = False
    pool = DecodePool(decode_workers,
                      fuse_runs=knob(decode_fuse_runs, cfg.decode_fuse_runs))
    shape = (batch, image_size, image_size, 3)
    # what a batch slot holds: the decoded images, or the graph's output
    out_shape = (batch,) + (cgraph.out_shape if cgraph is not None
                            else shape[1:])
    out_dtype = cgraph.out_dtype if cgraph is not None else np.dtype(np.uint8)
    out_bytes = int(np.prod(out_shape)) * out_dtype.itemsize

    def labels_out(labels: Sequence[int]) -> torch.Tensor:
        return torch.from_numpy(np.asarray(labels, dtype=np.int32)).to(device)

    def make_batch(indices: np.ndarray, serial: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        samples = [ss.samples[int(i)] for i in indices]
        rngs = [np.random.Generator(np.random.Philox(
                    key=[seed, (serial << 32) + r])) for r in range(batch)]
        ckeys = served = None
        if dcache is not None:
            # the image member's physical extent: stable across epochs
            ckeys = [dcache.key(s.shard, s.members[image_ext].offset,
                                s.members[image_ext].offset
                                + s.members[image_ext].size)
                     for s in samples]
            # probe before planning the gather: a resident frame skips its
            # image member's read (only labels and misses reach the engine)
            served = [dcache.probe(ck, s.members[image_ext].size)
                      for ck, s in zip(ckeys, samples)]
            if all(sv is None for sv in served):
                served = None
        if served is not None:
            el = ExtentList.concat([
                s.extents([label_ext] if sv is not None
                          else [image_ext, label_ext])
                for s, sv in zip(samples, served)])
            sizes = [(0 if sv is not None else s.members[image_ext].size,
                      s.members[label_ext].size)
                     for s, sv in zip(samples, served)]
        else:
            el = ss.batch_extents([int(i) for i in indices],
                                  [image_ext, label_ext])
            sizes = [(s.members[image_ext].size, s.members[label_ext].size)
                     for s in samples]
        try:
            out = assemble_batch(el, sizes, rngs, ckeys, served)
            if cgraph is not None:
                cgraph.flush_stats(ctx._count)
            return out
        except BaseException:
            # a transform releases its frame; a batch that died before (or
            # instead of) a transform still holds pins: release is
            # idempotent, so sweep them all
            for sv in served or ():
                if sv is not None:
                    sv.release()
            raise

    def assemble_batch(el, sizes, rngs, ckeys, served
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        if not to_slot:
            buf = ctx.pread(el, tenant=tname)
            blobs, labels = _split_members(buf, sizes, served)
            images = np.stack(pool.map(tf, blobs, rngs))
            if cgraph is not None:
                images = cgraph.apply_batch(images)
            return torch.from_numpy(images).to(device), labels_out(labels)
        # workers write the final rows straight into the batch slot (with a
        # graph, into a decode slot the graph reads from)
        slot = ctx.host_batch((out_bytes,), device).view(out_dtype).reshape(
            out_shape)
        images = slot if cgraph is None else np.empty(shape, np.uint8)
        put_called = False

        def put(imgs: np.ndarray) -> torch.Tensor:
            nonlocal put_called
            if cgraph is not None:
                cgraph.apply_batch(imgs, out=slot)
            put_called = True   # put_host_batch hands the slot back itself
            return ctx.put_host_batch(slot, device)

        try:
            if stream:
                out, labels = _decode_put_streamed(ctx, pool, tf, el, sizes,
                                                   rngs, images, put, counts,
                                                   ckeys, served, tname)
                return out, labels_out(labels)
            buf = ctx.pread(el, tenant=tname)
            blobs, labels = _split_members(buf, sizes, served)
            if overlap_put:
                out = _decode_put_overlapped(pool, tf, blobs, rngs, images,
                                             put, ckeys)
            else:
                pool.map_into(tf, blobs, rngs, images, ckeys)
                out = put(images)
            return out, labels_out(labels)
        except BaseException:
            # a batch that failed before its put (every decode job has
            # finished by now) hands the slot back here
            if not put_called:
                ctx.release_host_batch(slot, device)
            raise

    depth = prefetch_depth if prefetch_depth is not None else cfg.prefetch_depth
    auto, max_depth = _auto_depth_bounds(ctx, auto_prefetch, out_bytes)
    # warm the members of the upcoming batches (the tar payloads are read
    # again every epoch; decode still runs per step, the gather not)
    ra = _make_readahead(
        ctx, sampler,
        lambda indices: ss.batch_extents([int(i) for i in indices],
                                         [image_ext, label_ext]),
        tenant=tname)

    def counters() -> dict:
        out = {"decode_errors": pool.decode_errors, **counts.snapshot()}
        if dcache is not None:
            out.update(dcache.stats())
        if scope:
            out["scope"] = dict(scope)
        return out

    return Pipeline(sampler, make_batch, depth=depth, auto_depth=auto,
                    max_depth=max_depth, fingerprint=fp,
                    on_close=_chain_close(ra.close if ra else None,
                                          pool.close),
                    counters=counters, scope=pscope)


def _split_members(buf: np.ndarray, sizes: Sequence[tuple[int, int]],
                   served: "Sequence | None" = None
                   ) -> tuple[list, list[int]]:
    """A gathered batch buffer back into per-sample image members and
    labels (a label member is its class index in ASCII). A row served from
    the decoded cache at plan time (image bytes 0) carries its
    ``ServedFrame`` in place of bytes that were never gathered."""
    blobs, labels, pos = [], [], 0
    for i, (isz, lsz) in enumerate(sizes):
        if served is not None and served[i] is not None:
            blobs.append(served[i])
        else:
            blobs.append(buf[pos: pos + isz])
        labels.append(int(buf[pos + isz: pos + isz + lsz].tobytes() or b"0"))
        pos += isz + lsz
    return blobs, labels


def make_predecoded_vision_pipeline(ctx: StromContext, paths: Sequence[str],
                                    *, batch: int, image_size: int,
                                    device: Any = None,
                                    seed: int = 0,
                                    shuffle: bool = True,
                                    prefetch_depth: int | None = None,
                                    auto_prefetch: bool | None = None,
                                    resume_from: "str | SamplerState | None" = None,
                                    scope: dict | None = None
                                    ) -> Pipeline:
    """Decode-free vision loader over predecoded shards
    (:mod:`strom_torch.formats.predecoded`): each batch is one engine gather
    and one host-to-device copy, the Llama loader's mechanics with pixel
    records. Normalisation belongs to the train step.

    Yields ``(images [B,S,S,3] uint8, labels [B] int32)`` on *device*.
    *scope*: labels of the pipeline's telemetry scope (default
    ``{"pipeline": "predecoded"}``); a ``"tenant"`` label routes the
    gathers and the readahead's admissions to that tenant."""
    device = resolve_device(device)
    # sizes through the context, so striped-set aliases (paths that need
    # not exist on disk) work as the Llama loader's shards do
    shards = PredecodedShardSet(
        tuple(paths), image_size,
        shard_sizes=tuple(source_size(ctx.resolve_source(p)) for p in paths))
    if shards.num_records < batch:
        raise ValueError(f"dataset has {shards.num_records} samples < batch "
                         f"{batch}")
    state, fp = resolve_state(tuple(paths), seed=seed, resume_from=resume_from,
                              ctx=ctx)
    sampler = EpochShuffleSampler(shards.num_records, batch, seed=seed,
                                  shuffle=shuffle, state=state)
    pscope = ctx.scope.scoped(**(scope if scope is not None
                                 else {"pipeline": "predecoded"}))
    tname = getattr(pscope, "labels", {}).get("tenant")
    shape = (batch, image_size, image_size, 3)

    def make_batch(indices: np.ndarray, serial: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        imgs = ctx.memcpy_ssd2gpu(shards.extents([int(i) for i in indices]),
                                  shape=shape, dtype=np.uint8, device=device,
                                  tenant=tname)
        lbls = torch.from_numpy(shards.labels(indices)).to(device)
        return imgs, lbls

    depth = prefetch_depth if prefetch_depth is not None \
        else ctx.config.prefetch_depth
    auto, max_depth = _auto_depth_bounds(ctx, auto_prefetch,
                                         batch * image_size * image_size * 3)
    # a pure engine gather: warming the upcoming record extents turns a
    # later epoch into RAM copies end to end
    ra = _make_readahead(ctx, sampler,
                         lambda indices: shards.extents([int(i)
                                                         for i in indices]),
                         tenant=tname)
    return Pipeline(sampler, make_batch, depth=depth, auto_depth=auto,
                    max_depth=max_depth, fingerprint=fp,
                    on_close=ra.close if ra else None, scope=pscope)


def make_imagenet_resnet_pipeline(ctx: StromContext, paths: Sequence[str], *,
                                  batch: int, image_size: int = 224,
                                  device: Any = None, **kw: Any) -> Pipeline:
    """BASELINE config #2: ImageNet raw-JPEG WebDataset shards → the
    ResNet-50 input pipeline, its stats tagged ``{"pipeline": "resnet"}``."""
    kw.setdefault("scope", {"pipeline": "resnet"})
    return make_wds_vision_pipeline(ctx, paths, batch=batch,
                                    image_size=image_size, device=device, **kw)


def make_vit_wds_pipeline(ctx: StromContext, paths: Sequence[str], *,
                          batch: int, image_size: int = 224,
                          device: Any = None, **kw: Any) -> Pipeline:
    """BASELINE config #3: WebDataset .tar shards → the ViT-B/16 training
    loader; the mechanics of :func:`make_wds_vision_pipeline`, with its
    stats tagged ``scope={"pipeline": "vit"}``. The shard *paths* typically
    name striped-set aliases (``register_striped``), so each batch's gather
    fans out over the members."""
    kw.setdefault("scope", {"pipeline": "vit"})
    return make_wds_vision_pipeline(ctx, paths, batch=batch,
                                    image_size=image_size, device=device, **kw)
