"""Vision pipelines over WebDataset and predecoded shards: ImageNet →
ResNet-50 (BASELINE config #2) and WebDataset → ViT-B/16 (config #3), the
port's counterpart of ``strom/pipelines/vision.py``.

A batch goes to one device (``device=``) or is sharded over a mesh
(``sharding=``, a :class:`~strom_torch.parallel.sharding.TorchSharding` that
splits the batch dimension only). Sharded, each process gathers and
decodes only the rows its own card consumes, keys their augmentation by
the global row index (so every world size gives the same rows), and the
batch is the global ``DTensor``. The reference's per-device row groups are
kept: this process's rows form the groups of its devices, one a card, so
one group a process, put the moment its last row decodes.

Per JPEG batch: gather the samples' members with the engine, decode and
augment them on the host decode pool straight into the batch slot (a
pinned slab from the context's pool on a CUDA target), copy the slot to the
card. With ``stream_intra_batch`` (the default) the gather is
completion-driven: each sample goes to the decode pool the moment its
extents land, so read and decode overlap within the batch. Batches are
bit-identical either way. Each batch build is one traced ``batch``
request of the pipeline's tenant and context.

The predecoded pipeline is a pure engine gather and one copy per batch: no
decoder on the host at all.

With the hot cache on (``hot_cache_bytes``), both pipelines warm the
sampler's upcoming batches into it from a readahead thread
(``readahead_window_batches``), and the JPEG pipeline can keep decoded
frames there too (``decode_cache``): a frame found at plan time skips its
member's read and its decode, leaving crop and resize. On a context with
peers (``ctx.attach_peers``) a frame missing here is asked of its owner's
decoded cache first, so a frame decoded once is decoded once in the
cluster.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import inspect
import queue as _queue
import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Sequence

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
from strom_torch.obs import request as _request
from strom_torch.obs.events import ring
from strom_torch.parallel.sharding import P, TorchSharding
from strom_torch.pipelines.base import (Pipeline, _auto_depth_bounds,
                                        resolve_state)
from strom_torch.pipelines.sampler import EpochShuffleSampler, SamplerState
from strom_torch.utils.locks import make_lock
from strom_torch.utils.stats import global_stats

if TYPE_CHECKING:
    from strom_torch.ckpt.jobstate import StepToken

    # what resume_from takes: a loader-state path, a position, or a token
    ResumeFrom = str | SamplerState | StepToken | None

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

    ra = Readahead(ctx, window, tenant=tenant,
                   window_batches=ctx.config.readahead_window_batches)
    ctx.register_tunable("readahead", ra)
    return ra


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


def _validate_batch_only(sharding: TorchSharding, rank: int = 4) -> None:
    """Image pipelines shard the batch dimension only: a spec that splits
    H, W or C raises here, at construction."""
    spec = tuple(sharding.spec) + (None,) * (rank - len(sharding.spec))
    split_inner = [i for i, s in enumerate(spec[1:], start=1) if s is not None]
    if split_inner:
        raise ValueError(
            "vision pipelines deliver batch-dim-sharded images only: "
            f"PartitionSpec {tuple(sharding.spec)} shards inner dim(s) "
            f"{split_inner} (H/W/C must be None/replicated)")


def _local_batch_rows(sharding: TorchSharding, batch: int) -> dict:
    """device -> (row_lo, row_hi) of the global batch this process feeds:
    the sharding collapsed to its batch axis, so each device's block is a
    contiguous row range (one entry: one rank, one card)."""
    spec0 = sharding.spec[0] if len(sharding.spec) else None
    probe = TorchSharding(sharding.mesh, P(spec0))
    out = {}
    for device, index in probe.addressable_devices_indices_map(
            (batch,)).items():
        lo, hi, _ = index[0].indices(batch)
        out[device] = (lo, hi)
    return out


def _batch_rows(sharding: TorchSharding | None, device: Any, batch: int
                ) -> tuple[torch.device, dict]:
    """(this process's device, its rows by device) for a pipeline given
    *device* or *sharding* (exclusive): the whole batch on *device*, or
    this rank's rows of a batch-dim sharding, checked as the reference
    checks it."""
    if sharding is not None and device is not None:
        raise ValueError("pass device= or sharding=, not both")
    if sharding is None:
        device = resolve_device(device)
        return device, {device: (0, batch)}
    if not isinstance(sharding, TorchSharding):
        raise TypeError("vision pipelines need a TorchSharding (labels "
                        "derive their spec from its batch axis)")
    if len(sharding.spec) > 4:
        raise ValueError("sharding.spec must have rank <= 4 (B, H, W, C)")
    _validate_batch_only(sharding)
    rows = _local_batch_rows(sharding, batch)
    if len(rows) != 1:
        raise ValueError(f"{sharding!r} gives this process {len(rows)} "
                         "devices; a process delivers to one (one rank, "
                         "one card)")
    return next(iter(rows)), rows


def _label_sharding(sharding: TorchSharding) -> TorchSharding:
    """Labels [B] take the images' batch-axis spec."""
    return TorchSharding(sharding.mesh,
                         P(sharding.spec[0] if len(sharding.spec) else None))


def _init_group_state(images: np.ndarray, dev_items: Sequence,
                      row_pos: dict, put: Callable[[int, np.ndarray], Any]
                      ) -> tuple[list[list[int]], list[int], list]:
    """Per-device completion bookkeeping shared by the overlapped and
    streamed batch paths: which device groups each row feeds, how many rows
    each group still waits on, and the puts of empty row ranges (nothing
    to wait for). *put(group, rows)* delivers one group."""
    pos_devs: list[list[int]] = [[] for _ in range(images.shape[0])]
    pending: list[int] = []
    shards: list = [None] * len(dev_items)
    for di, (_, (lo, hi)) in enumerate(dev_items):
        for r in range(lo, hi):
            pos_devs[row_pos[r]].append(di)
        pending.append(hi - lo)
        if hi <= lo:
            shards[di] = put(di, images[0:0])
    return pos_devs, pending, shards


def _put_ready_groups(rows: Sequence[int], pos_devs: list[list[int]],
                      pending: list[int], dev_items: Sequence,
                      row_pos: dict, images: np.ndarray, shards: list,
                      put: Callable[[int, np.ndarray], Any]) -> bool:
    """Count decoded *rows* (slot positions) off their groups and put each
    group whose last row this was. Returns whether anything was put."""
    fired = False
    for p in rows:
        for di in pos_devs[p]:
            pending[di] -= 1
            if pending[di] == 0:
                _, (lo, hi) = dev_items[di]
                base = row_pos[lo]
                shards[di] = put(di, images[base: base + hi - lo])
                fired = True
    return fired


def _note_decode_overlap(scope, t_decode0: float | None,
                         t_first_put: float | None,
                         t_last_decode: float | None) -> None:
    """The ``decode_batch`` histogram and the decode/put overlap
    (``decode_put_overlap_ms``, the ``decode.put_overlap`` instant), the
    same from the overlapped and the streamed path. *scope* is the
    pipeline's telemetry scope (its series and the aggregate)."""
    if t_decode0 is None or t_last_decode is None:
        return
    scope.observe_us("decode_batch", (t_last_decode - t_decode0) * 1e6)
    if t_first_put is not None and t_last_decode > t_first_put:
        scope.add("decode_put_overlap_ms",
                  int((t_last_decode - t_first_put) * 1000))
        # a first put fired while decode was still in flight, for this long
        ring.instant("decode.put_overlap", cat="decode",
                     args={"overlap_ms":
                           round((t_last_decode - t_first_put) * 1e3, 2)})


def _decode_put_overlapped(pool: DecodePool, tf: Transform, blobs: Sequence,
                           rngs: Sequence, images: np.ndarray,
                           dev_items: Sequence, row_pos: dict,
                           put: Callable[[int, np.ndarray], Any], scope=None,
                           ckeys: "Sequence | None" = None) -> list:
    """Decode every row into its slot and put each device's row group the
    moment its rows finish (completion-ordered). Contiguous rows fuse into
    one pool task per ``pool.run_size``. Returns one put a group, in
    *dev_items*' order. Every job has finished before an error
    surfaces."""
    n = images.shape[0]
    pos_devs, pending, shards = _init_group_state(images, dev_items, row_pos,
                                                  put)
    run = pool.run_size(n)
    futs: dict = {}
    if run <= 1:
        for i in range(n):
            futs[pool.submit_into(tf, blobs[i], rngs[i], images[i],
                                  None if ckeys is None else ckeys[i])] = (i,)
    else:
        for i in range(0, n, run):
            grp = tuple(range(i, min(i + run, n)))
            futs[pool.submit_run_into(
                tf, [blobs[j] for j in grp], [rngs[j] for j in grp],
                [images[j] for j in grp],
                None if ckeys is None else [ckeys[j] for j in grp])] = grp
    t0 = time.perf_counter()
    t_first_put = None
    t_last_decode = t0
    try:
        for f in concurrent.futures.as_completed(futs):
            f.result()  # decode ValueErrors are absorbed per row by the
            # pool; anything else (a transform bug) aborts the batch
            t_last_decode = t_put = time.perf_counter()
            if _put_ready_groups(futs[f], pos_devs, pending, dev_items,
                                 row_pos, images, shards, put) \
                    and t_first_put is None:
                t_first_put = t_put
    except BaseException:
        concurrent.futures.wait(futs)
        raise
    _note_decode_overlap(scope or global_stats, t0, t_first_put,
                         t_last_decode)
    return shards


def _decode_put_streamed(ctx: StromContext, pool: DecodePool, tf: Transform,
                         el, sizes: Sequence[tuple[int, int]],
                         rngs: Sequence, images: np.ndarray,
                         dev_items: Sequence, row_pos: dict,
                         put: Callable[[int, np.ndarray], Any],
                         counts: DecodeCounts, scope=None,
                         ckeys: "Sequence | None" = None,
                         served: "Sequence | None" = None,
                         tenant: str | None = None
                         ) -> tuple[list, list[int]]:
    """Completion-driven batch assembly: the member gather goes through
    ``ctx.stream_segments``, each sample goes to the decode pool the moment
    its extents land, and each device's row group is put the moment its
    rows decode.

    *sizes* is ``[(image_bytes, label_bytes)]`` per local row, in the order
    *el* concatenates them; a row *served* from the decoded cache at plan
    time has image_bytes 0 and decodes from its ``ServedFrame``. Returns
    ``(group puts, labels)``, the same contents as the barrier path: decode
    order differs, bytes do not.

    A pump thread drives the gather (poll → per-sample byte countdown →
    decode submit), so the engine's queue refills at read pace; it
    re-enters the batch's request, so that the gather's work joins it.
    Decode completions come back to this thread over a queue."""
    scope = scope or global_stats
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
    pos_devs, pending, shards = _init_group_state(images, dev_items, row_pos,
                                                  put)
    events: _queue.SimpleQueue = _queue.SimpleQueue()
    stop = threading.Event()
    futs: list[concurrent.futures.Future] = []
    futs_lock = make_lock("app.vision_futs")
    t_decode0: list[float | None] = [None]
    g = ctx.stream_segments(el, [Segment(0, 0, el.size)], buf,
                            tenant=tenant)
    # the batch's request, minted by make_batch on this thread
    req = _request.current()
    counts.add("stream_batches")
    # samples whose extents land together decode together: ready rows are
    # flushed after every poll, in runs of at most run_size
    run = pool.run_size(n)
    ready: list[int] = []

    def mark_ready(i: int) -> None:
        isz, lsz = sizes[i]
        s = starts[i]
        labels[i] = int(buf[s + isz: s + isz + lsz].tobytes() or b"0")
        if t_decode0[0] is None:
            t_decode0[0] = time.perf_counter()
            # gather start to the first decode dispatch
            scope.observe_us("stream_first_decode_lat",
                             ring.now_us() - g.t0_us)
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
        with _request.attach(req):
            _pump()

    def _pump() -> None:
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
    t_first_put: float | None = None
    t_last_decode: float | None = None
    try:
        while decoded < n or not gather_done:
            kind, *payload = events.get()
            if kind == "decoded":
                grp, fut = payload
                fut.result()  # per-sample decode errors were absorbed by
                # the pool; anything else aborts the batch
                decoded += len(grp)
                t_last_decode = t_put = time.perf_counter()
                if _put_ready_groups(grp, pos_devs, pending, dev_items,
                                     row_pos, images, shards, put) \
                        and t_first_put is None:
                    t_first_put = t_put
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
    _note_decode_overlap(scope, t_decode0[0], t_first_put, t_last_decode)
    return shards, labels


def make_wds_vision_pipeline(ctx: StromContext, paths: Sequence[str], *,
                             batch: int,
                             image_size: int,
                             device: Any = None,
                             sharding: TorchSharding | None = None,
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
                             resume_from: "ResumeFrom" = None,
                             scope: dict | None = None
                             ) -> Pipeline:
    """Infinite stream of ``(images [B,S,S,3] uint8, labels [B] int32)``
    tensors (images in the *opgraph*'s output shape and dtype where one is
    given) on *device* (None → the current CUDA device; raises without
    one). The decode knobs default to the context's config.

    *sharding* (instead of *device*): a
    :class:`~strom_torch.parallel.sharding.TorchSharding` of the rank-4
    image batch that splits the batch dimension only (``P("dp", None,
    None, None)``; a spec that splits H, W or C raises ``ValueError``).
    This process then gathers and decodes only its own rows, and the batch
    is a pair of global ``DTensor``s, the labels sharded as the batch axis
    (``P(spec[0])``). Every process builds the pipeline with the same
    arguments.

    Augmentation is deterministic in (seed, batch serial, global row):
    Philox keys ``[seed, (serial << 32) + row]``, identical across resume
    and across world sizes. ``pipe.stats()`` reports ``data_stall_steps``,
    the prefetcher's counters, ``decode_errors``, the decode routes taken,
    the streamed counters (``stream_batches``, ``stream_samples_early``),
    the decoded cache's (``decode_cache_*``) and, given one, the *scope*
    labels under ``"scope"``.

    *decode_cache* (needs the context's hot cache and the built-in
    transform) keeps full decoded frames in the hot cache: a frame found
    at plan time skips its member's read and its decode; with peers
    attached, a local miss is asked of the owning peer's cache before the
    read is planned. Cached frames are full-resolution, so batches equal the cache-off pipeline's bit for bit
    where that one decodes in full too (``decode_reduced_scale=False``).

    *opgraph*: a :class:`strom_torch.ops.pushdown.OpGraph` compiled once
    against the decoded sample geometry (``(image_size, image_size, 3)``
    uint8) and run on the host between decode and the copy to the device,
    writing the batch slot, which is sized from the graph's output shape and
    dtype; the delivered images take that shape and dtype. With
    *opgraph_fuse* (default on) the graph runs the moment a device group's
    rows have decoded, inside the completion-ordered dispatch;
    ``opgraph_fuse=False`` is the parity reference: barrier decode, then
    one batch-wise apply. Both give bit-identical batches (the kernel is
    per-sample deterministic). The ``ops_*`` counters go to the context's
    (``ctx.stats()``).

    *scope*: labels of the pipeline's telemetry scope over the context's
    (default ``{"pipeline": "vision"}``); a ``"tenant"`` label routes every
    gather, the readahead's admissions and the decoded cache's frames to
    that tenant (its scheduler queue and cache partition)."""
    device, rows_by_device = _batch_rows(sharding, device, batch)
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
                              fingerprint=f"rgb8/{engine}", scope=pscope)
        # registered: the peer server exports its frames to the cluster
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
    ctx.register_tunable("decode_pool", pool)
    # the union of rows this process decodes, and each device's slice of it
    local_rows = sorted({r for lo, hi in rows_by_device.values()
                         for r in range(lo, hi)})
    row_pos = {r: i for i, r in enumerate(local_rows)}
    dev_items = list(rows_by_device.items())
    n_local = len(local_rows)
    shape = (n_local, image_size, image_size, 3)
    # what a batch slot holds: the decoded images, or the graph's output
    sample_out = cgraph.out_shape if cgraph is not None else shape[1:]
    out_shape = (n_local,) + tuple(sample_out)
    global_shape = (batch,) + tuple(sample_out)
    out_dtype = cgraph.out_dtype if cgraph is not None else np.dtype(np.uint8)
    out_bytes = int(np.prod(out_shape)) * out_dtype.itemsize
    label_sharding = _label_sharding(sharding) if sharding is not None \
        else None

    def globalize(images: torch.Tensor, labels: Sequence[int]
                  ) -> tuple[Any, Any]:
        lbls = torch.from_numpy(np.asarray(labels, dtype=np.int32)).to(device)
        if sharding is None:
            return images, lbls
        return (sharding.to_global(images, global_shape),
                label_sharding.to_global(lbls, (batch,)))

    def make_batch(indices: np.ndarray, serial: int) -> tuple[Any, Any]:
        samples = [ss.samples[int(indices[r])] for r in local_rows]
        # Philox keys are two 64-bit words: (seed, serial ‖ global row)
        rngs = [np.random.Generator(np.random.Philox(
                    key=[seed, (serial << 32) + r])) for r in local_rows]
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
            # a local miss may be resident in the owning peer's
            # DecodedCache: its RGB comes over the batch wire, is offered
            # here and probed again (a refused admission falls back to the
            # gather: never wrong pixels)
            for j, sv in enumerate(served):
                if sv is not None:
                    continue
                img = ctx.peer_decoded_fetch(ckeys[j])
                if img is None:
                    continue
                dcache.offer(ckeys[j], img)
                served[j] = dcache.probe(ckeys[j],
                                         samples[j].members[image_ext].size)
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
            el = ss.batch_extents([int(indices[r]) for r in local_rows],
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

    def assemble_batch(el, sizes, rngs, ckeys, served) -> tuple[Any, Any]:
        if not to_slot:
            buf = ctx.pread(el, tenant=tname)
            blobs, labels = _split_members(buf, sizes, served)
            t0 = time.perf_counter()
            images = np.stack(pool.map(tf, blobs, rngs))
            pscope.observe_us("decode_batch",
                              (time.perf_counter() - t0) * 1e6)
            if cgraph is not None:
                images = cgraph.apply_batch(images)
            return globalize(torch.from_numpy(images).to(device), labels)
        # workers write the final rows straight into the batch slot (with a
        # graph, into a decode array the graph reads from)
        slot = ctx.host_batch((out_bytes,), device, source=el).view(
            out_dtype).reshape(out_shape)
        images = slot if cgraph is None else np.empty(shape, np.uint8)
        put_called = False

        def put(di: int, rows: np.ndarray) -> torch.Tensor:
            # a process feeds one device, so its one group's rows are the
            # whole slot
            nonlocal put_called
            if cgraph is not None:
                cgraph.apply_batch(rows, out=slot)
            put_called = True   # put_host_batch hands the slot back itself
            return ctx.put_host_batch(slot, device)

        try:
            if stream:
                (out,), labels = _decode_put_streamed(
                    ctx, pool, tf, el, sizes, rngs, images, dev_items,
                    row_pos, put, counts, pscope, ckeys, served, tname)
            else:
                buf = ctx.pread(el, tenant=tname)
                blobs, labels = _split_members(buf, sizes, served)
                if overlap_put:
                    (out,) = _decode_put_overlapped(
                        pool, tf, blobs, rngs, images, dev_items, row_pos,
                        put, pscope, ckeys)
                else:
                    t0 = time.perf_counter()
                    pool.map_into(tf, blobs, rngs, images, ckeys)
                    pscope.observe_us("decode_batch",
                                      (time.perf_counter() - t0) * 1e6)
                    out = put(0, images)
        except BaseException:
            # a batch that failed before its put (every decode job has
            # finished by now) hands the slot back here
            if not put_called:
                ctx.release_host_batch(slot, device)
            raise
        # billed once the decode has completed: an aborted batch claims no
        # slot bytes
        pscope.add("decode_slot_bytes", images.nbytes)
        return globalize(out, labels)

    def traced_make_batch(indices: np.ndarray, serial: int
                          ) -> tuple[Any, Any]:
        # one traced request a batch build: the gather (pread or streamed),
        # the scheduler's waits, the decode jobs and the puts join it
        with _request.active("batch", tname, owner=ctx._req_owner):
            return make_batch(indices, serial)

    depth = prefetch_depth if prefetch_depth is not None else cfg.prefetch_depth
    # the ceiling from this process's rows, as the reference sizes it
    auto, max_depth = _auto_depth_bounds(
        ctx, auto_prefetch, n_local * image_size * image_size * 3)
    # warm this process's members of the upcoming batches (the tar
    # payloads are read again every epoch; decode still runs per step)
    ra = _make_readahead(
        ctx, sampler,
        lambda indices: ss.batch_extents([int(indices[r]) for r in local_rows],
                                         [image_ext, label_ext]),
        tenant=tname)

    def counters() -> dict:
        out = {"decode_errors": pool.decode_errors, **counts.snapshot()}
        if dcache is not None:
            out.update(dcache.stats())
        if scope:
            out["scope"] = dict(scope)
        return out

    return Pipeline(sampler, traced_make_batch, depth=depth, auto_depth=auto,
                    max_depth=max_depth, fingerprint=fp,
                    on_close=_chain_close(ra.close if ra else None,
                                          pool.close),
                    counters=counters, scope=pscope,
                    req_owner=ctx._req_owner)


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
                                    sharding: TorchSharding | None = None,
                                    seed: int = 0,
                                    shuffle: bool = True,
                                    prefetch_depth: int | None = None,
                                    auto_prefetch: bool | None = None,
                                    resume_from: "ResumeFrom" = None,
                                    scope: dict | None = None
                                    ) -> Pipeline:
    """Decode-free vision loader over predecoded shards
    (:mod:`strom_torch.formats.predecoded`): each batch is one engine gather
    and one host-to-device copy, the Llama loader's mechanics with pixel
    records. Normalisation belongs to the train step.

    Yields ``(images [B,S,S,3] uint8, labels [B] int32)`` on *device*, or,
    given *sharding* (batch dimension only, as
    :func:`make_wds_vision_pipeline` takes it), as global ``DTensor``s of
    which this process read only its own rows' bytes
    (``memcpy_ssd2gpu(sharding=)``). *scope*: labels of the pipeline's
    telemetry scope (default ``{"pipeline": "predecoded"}``); a
    ``"tenant"`` label routes the gathers and the readahead's admissions
    to that tenant."""
    device, rows_by_device = _batch_rows(sharding, device, batch)
    ((lo, hi),) = rows_by_device.values()
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
    label_sharding = _label_sharding(sharding) if sharding is not None \
        else None
    where = {"device": device} if sharding is None else {"sharding": sharding}

    def make_batch(indices: np.ndarray, serial: int) -> tuple[Any, Any]:
        with _request.active("batch", tname, owner=ctx._req_owner):
            imgs = ctx.memcpy_ssd2gpu(
                shards.extents([int(i) for i in indices]), shape=shape,
                dtype=np.uint8, tenant=tname, **where)
            lbls = torch.from_numpy(shards.labels(indices)[lo:hi]).to(device)
            if label_sharding is not None:
                lbls = label_sharding.to_global(lbls, (batch,))
            return imgs, lbls

    depth = prefetch_depth if prefetch_depth is not None \
        else ctx.config.prefetch_depth
    # the ceiling from the whole batch, as the reference sizes it
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
                    on_close=ra.close if ra else None, scope=pscope,
                    req_owner=ctx._req_owner)


def make_imagenet_resnet_pipeline(ctx: StromContext, paths: Sequence[str], *,
                                  batch: int, image_size: int = 224,
                                  device: Any = None,
                                  sharding: TorchSharding | None = None,
                                  **kw: Any) -> Pipeline:
    """BASELINE config #2: ImageNet raw-JPEG WebDataset shards → the
    ResNet-50 input pipeline, its stats tagged ``{"pipeline": "resnet"}``."""
    kw.setdefault("scope", {"pipeline": "resnet"})
    return make_wds_vision_pipeline(ctx, paths, batch=batch,
                                    image_size=image_size, device=device,
                                    sharding=sharding, **kw)


def make_vit_wds_pipeline(ctx: StromContext, paths: Sequence[str], *,
                          batch: int, image_size: int = 224,
                          device: Any = None,
                          sharding: TorchSharding | None = None,
                          **kw: Any) -> Pipeline:
    """BASELINE config #3: WebDataset .tar shards → the ViT-B/16 training
    loader; the mechanics of :func:`make_wds_vision_pipeline`, with its
    stats tagged ``scope={"pipeline": "vit"}``. The shard *paths* typically
    name striped-set aliases (``register_striped``), so each batch's gather
    fans out over the members."""
    kw.setdefault("scope", {"pipeline": "vit"})
    return make_wds_vision_pipeline(ctx, paths, batch=batch,
                                    image_size=image_size, device=device,
                                    sharding=sharding, **kw)
