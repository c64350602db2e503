"""Parquet columnar scan (BASELINE config #5; the port's counterpart of
``strom/pipelines/parquet_scan.py``) on one device or a few of one process.

Row groups are the scan unit. Planning walks the footers: a predicate's
refuted groups are never submitted, and the rest are assigned to processes
by selected bytes (LPT). Per unit (or per ``unit_batch`` of units), a
prefetch thread gathers only the selected columns' chunks through the
engine, decodes them on the host (PLAIN chunks as views over the gathered
bytes), applies the predicate's row mask, and packs every column into one
pinned slab, each column at a 16-byte boundary, which goes to the device in
ONE host-to-device copy. ``map_fn`` then computes the unit's partial
aggregate from device tensors, one a column in its own dtype, and the
partials are summed on the first device. Nothing in the loop waits for the
device: the one copy to the host is of the final aggregate.

The reference sums in JAX's default 32-bit mode, so its float64 columns
reach ``map_fn`` as float32; here a float64 column stays float64 (the
narrowing is no part of the scan's semantics).

``devices=["cpu"]`` runs the same code on the CPU (dispatch by device, not
a fallback). Across processes (``torch.distributed`` initialised) every
process scans its LPT share and the partials are summed over the group,
as the reference sums them: ``reduce="collective"`` all-reduces every
leaf where it lies (NCCL for a leaf on the card, the gloo host group for
one on the CPU), ``"allgather"`` gathers the host partials over gloo and
sums them. A process that drew no unit contributes zeros.
"""

from __future__ import annotations

import concurrent.futures
import time
from functools import partial
from typing import Any, Callable, Sequence

import numpy as np
import torch

from strom_torch.delivery.core import StromContext, resolve_device, torch_dtype
from strom_torch.delivery.prefetch import Prefetcher, bound_depth
from strom_torch.formats.parquet import ParquetShard
from strom_torch.parallel import mesh as _mesh
from strom_torch.parallel.multihost import assign_balanced

# map_fn: dict[column -> tensor of the unit's rows] -> tree of aggregates
# (dicts, lists and tuples of tensors)
MapFn = Callable[[dict], Any]

ALIGN = 16   # a packed column's start: view(dtype) of a device slice needs it


def scan_units(shards: Sequence[ParquetShard]) -> list[tuple[ParquetShard, int]]:
    """All (shard, row_group) scan units, in deterministic order."""
    return [(s, g) for s in shards for g in range(s.num_row_groups)]


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """*fn* over the leaves of dicts, lists and tuples (of equal structure
    in *tree* and *rest*)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _tree_leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _to_host(tree: Any) -> Any:
    """The aggregate with numpy leaves, in ONE device-to-host copy: every
    tensor leaf's bytes, each padded to ALIGN, concatenated on its device,
    copied, then cut back into arrays on the host."""
    tensors = [t for t in _tree_leaves(tree) if isinstance(t, torch.Tensor)]
    if not tensors:
        return _tree_map(np.asarray, tree)
    parts = []
    for t in tensors:
        b = t.detach().reshape(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % ALIGN:
            parts.append(b.new_zeros(ALIGN - b.numel() % ALIGN))
    flat = torch.cat(parts).cpu()
    pos = 0

    def cut(leaf: Any) -> Any:
        nonlocal pos
        if not isinstance(leaf, torch.Tensor):
            return np.asarray(leaf)
        nbytes = leaf.numel() * leaf.element_size()
        arr = flat[pos: pos + nbytes].view(leaf.dtype).reshape(
            leaf.shape).numpy()
        pos += _align(nbytes)
        return arr

    return _tree_map(cut, tree)


def _zero(leaf: Any) -> Any:
    return torch.zeros_like(leaf) if isinstance(leaf, torch.Tensor) \
        else leaf * 0


def _add(a: Any, b: Any) -> Any:
    return a + b


def _process_layout(process_index: int | None, process_count: int | None
                    ) -> tuple[int, int]:
    """(index, count) of this scan's process partition: the arguments where
    given, else torch.distributed's rank and world size (0 and 1 without a
    group)."""
    return (_mesh.rank() if process_index is None else process_index,
            _mesh.world_size() if process_count is None else process_count)


def _collective_sum(acc: Any) -> Any:
    """Every leaf summed over the group where it lies: a tensor on the card
    over the default (NCCL) group, on the CPU over the gloo host group, a
    number as a CPU tensor. A collective: every process calls it with a
    tree of the same structure."""
    import torch.distributed as dist

    def leaf(x: Any) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        t = t.detach().clone()
        dist.all_reduce(t, group=None if t.is_cuda else _mesh.host_group())
        return t

    return _tree_map(leaf, acc)


def _allgather_sum(host: Any) -> Any:
    """The host partials (numpy leaves) gathered over gloo and summed on
    every process."""
    import torch.distributed as dist

    def leaf(x: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.array(x))   # a contiguous copy, 0-d kept
        rows = [torch.empty_like(t) for _ in range(_mesh.world_size())]
        dist.all_gather(rows, t, group=_mesh.host_group())
        return np.sum(np.stack([r.numpy() for r in rows]), axis=0)

    return _tree_map(leaf, host)


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _pack_column(dst: np.ndarray, parts: list) -> None:
    """Join one column's pages of each unit into *dst*, in unit order:
    ``(pages, mask)`` pairs, a mask selecting the rows that stay (None:
    all). Unmasked, a unit's pages are one numpy call."""
    k = 0
    for pages, m in parts:
        if m is None:
            n = sum(len(page) for page in pages)
            np.concatenate(pages, out=dst[k: k + n])
            k += n
            continue
        lo = 0
        for page in pages:
            sel = m[lo: lo + len(page)]
            cnt = int(np.count_nonzero(sel))
            np.compress(sel, page, out=dst[k: k + cnt])
            k += cnt
            lo += len(page)


def parquet_scan_aggregate(ctx: StromContext, paths: Sequence[str],
                           columns: Sequence[str], map_fn: MapFn, *,
                           predicate: Any = None,
                           prefetch_depth: int = 2,
                           auto_prefetch: bool | None = None,
                           unit_batch: int = 1,
                           devices: Sequence[Any] | None = None,
                           process_index: int | None = None,
                           process_count: int | None = None,
                           reduce: str = "collective",
                           decode_workers: int = 4,
                           scope: dict | None = None) -> Any:
    """Scan shards' row groups, sum map_fn's partial aggregates. Returns the
    aggregate tree with numpy leaves.

    *devices*: where ``map_fn`` runs, units cycling over them; None → the
    current CUDA device (raises without one); ``["cpu"]`` runs on the CPU.
    Partials are moved to ``devices[0]`` and summed there.

    Units are assigned to processes by BYTE SIZE (greedy LPT over the
    selected columns' chunk sizes, deterministic, computed identically on
    every process with no coordination); *process_index* / *process_count*
    default to torch.distributed's rank and world size where it is
    initialised, else 0 and 1. Explicit values scan one partition in this
    process (the partials of all partitions sum to the whole). *reduce*:
    with a process group, how the partials are summed across it
    (``"collective"``: an all-reduce of each leaf on its device;
    ``"allgather"``: the host partials gathered over gloo, summed on each
    process); without one, both return the local sum.

    unit_batch > 1 packs that many row groups' columns into one slab, one
    copy and one ``map_fn`` call: valid only when map_fn is
    row-decomposable (aggregate(rows_a ++ rows_b) == aggregate(rows_a) +
    aggregate(rows_b)), as count/sum/min-max shapes are.

    decode_workers > 1 reads and decodes a unit_batch's row groups on a
    thread pool; the packed order is the units' order, so results are
    identical to serial decode. Engages only when unit_batch > 1.

    *predicate* (a :class:`strom_torch.ops.pushdown.Predicate`) pushes
    filtering into the plan: row groups whose column statistics refute it
    are never submitted (the ``parquet_pushdown_*`` counters of
    ``ctx.stats()`` record the skipped/submitted bytes), and surviving
    groups are row-masked on the host after decode, so map_fn sees exactly
    the rows a post-hoc filter of the unpushed read would. Predicate-only
    columns are gathered for the mask but never reach map_fn. Missing or
    partial stats conservatively pass.

    ``ctx.stats()`` also counts the PLAIN and pyarrow bytes
    (``parquet_plain_bytes``, ``parquet_decode_bytes``), the units scanned
    (``parquet_scan_units``), the prefetch stalls
    (``parquet_scan_data_stalls``) and the microseconds the prefetch
    threads spent reading and decoding, packing, and copying to the device
    (``parquet_scan_read_us``, ``_pack_us``, ``_put_us``).

    *scope*: the scan's labels (``{"pipeline": "parquet", "tenant":
    name}``); a ``"tenant"`` label queues every chunk gather under that
    scheduler tenant. The scan's counters stay in ``ctx.stats()``.
    """
    if reduce not in ("collective", "allgather"):
        # fail in microseconds, not after the whole scan has run
        raise ValueError(f"reduce must be 'collective' or 'allgather', "
                         f"got {reduce!r}")
    if unit_batch < 1:
        raise ValueError(f"unit_batch must be >= 1, got {unit_batch}")
    if not columns:
        raise ValueError("a scan needs at least one column for map_fn")
    devs = [resolve_device(d) for d in devices] if devices is not None \
        else [resolve_device(None)]
    if not devs:
        raise ValueError("devices must name at least one device")
    idx, n_proc = _process_layout(process_index, process_count)
    # the scheduler tenant a tenant-labelled scope names, resolved once
    tname = (scope or {}).get("tenant")
    shards = [ParquetShard(p, ctx=ctx) for p in paths]
    units = scan_units(shards)
    if not units:
        raise ValueError("no row groups to scan")
    # each column's dtype (the schema's; a column no tensor can hold raises
    # here, before any read)
    dtypes = {c: shards[0].column_dtype(c) for c in columns}
    tdtypes = {c: torch_dtype(dt) for c, dt in dtypes.items()}
    # predicate pushdown: refute row groups against their column statistics
    # DURING planning, so a refuted group's chunks are never submitted.
    # Deterministic on every process (a pure metadata walk), so the LPT
    # assignment below stays coordination-free.
    read_cols = list(columns)
    if predicate is not None:
        from strom_torch.ops.pushdown import row_group_stats

        read_cols += sorted(predicate.columns() - set(columns))
        pred_cols = sorted(predicate.columns())
        kept: list = []
        skipped_bytes = submitted_bytes = 0
        for (s, g) in units:
            nbytes = s.column_chunk_extents(g, read_cols).size
            if predicate.refutes(row_group_stats(s, g, pred_cols)):
                skipped_bytes += nbytes
            else:
                kept.append((s, g))
                submitted_bytes += nbytes
        ctx._count(parquet_pushdown_groups_total=len(units),
                   parquet_pushdown_groups_skipped=len(units) - len(kept),
                   parquet_pushdown_skipped_bytes=skipped_bytes,
                   parquet_pushdown_submitted_bytes=submitted_bytes)
        units = kept
    # each unit's selected bytes: the LPT weights, and its gather's size
    sizes = {(s, g): s.column_chunk_extents(g, read_cols).size
             for (s, g) in units}
    local_units = [units[i] for i in assign_balanced(
        [sizes[u] for u in units], n_proc)[idx]] if units else []

    def read_unit(shard: ParquetShard, rg: int, buf: np.ndarray
                  ) -> tuple[dict, np.ndarray | None]:
        """One row group's selected columns as page lists (PLAIN pages view
        *buf*, the gather's slab), and the row mask (None without a
        predicate)."""
        pages = shard.read_row_group_pages(ctx, rg, read_cols, out=buf,
                                           tenant=tname)
        if predicate is None:
            return pages, None
        # the mask, in numpy as the reference computes it: with the
        # refutation pass it reproduces a post-hoc filter of the unpushed
        # read bit-identically (refuted groups contribute no rows by proof)
        m = predicate.mask({c: p[0] if len(p) == 1 else np.concatenate(p)
                            for c, p in pages.items()
                            if c in predicate.columns()})
        masked = int(m.size - np.count_nonzero(m))
        if masked:
            ctx._count(parquet_pushdown_rows_masked=masked)
        return pages, m

    # decode parallelism for a unit_batch's units; only built when it can
    # engage (chunks of >1 unit and >1 worker)
    decode_pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=decode_workers, thread_name_prefix="strom-pq-decode") \
        if decode_workers > 1 and unit_batch > 1 else None

    def load(chunk: list, device: torch.device) -> dict:
        """A prefetch thunk: read, decode and mask the chunk's units, pack
        their columns into one slab (the one join copy) and enqueue its copy
        to *device*. Returns the columns as views of the device tensor."""
        t0 = time.perf_counter()
        # the gathers land in recycled pool slabs (pinned and prefaulted
        # for a CUDA target), handed back once packed
        bufs = [ctx.host_batch((sizes[u],), device, source=u[0].path)
                for u in chunk]
        try:
            if decode_pool is not None and len(chunk) > 1:
                parts = list(decode_pool.map(
                    lambda ub: read_unit(*ub[0], ub[1]), zip(chunk, bufs)))
            else:
                parts = [read_unit(s, g, b)
                         for (s, g), b in zip(chunk, bufs)]
            n_rows = sum(int(np.count_nonzero(m)) if m is not None
                         else sum(len(p) for p in pages[columns[0]])
                         for pages, m in parts)
            layout = {}
            pos = 0
            for c in columns:
                layout[c] = (pos, n_rows * dtypes[c].itemsize)
                pos = _align(pos + n_rows * dtypes[c].itemsize)
            t1 = time.perf_counter()
            slab = ctx.host_batch((max(pos, ALIGN),), device)
            try:
                for c in columns:
                    off, nbytes = layout[c]
                    _pack_column(slab[off: off + nbytes].view(dtypes[c]),
                                 [(pages[c], m) for pages, m in parts])
                t2 = time.perf_counter()
                dev = ctx.put_host_batch(slab, device)
            except BaseException:
                ctx.release_host_batch(slab, device)
                raise
        finally:
            for b in bufs:
                ctx.release_host_batch(b, device)
        # each stage's seconds on the prefetch threads (they overlap one
        # another, and the reads of one thunk the packing of another)
        ctx._count(parquet_scan_read_us=int((t1 - t0) * 1e6),
                   parquet_scan_pack_us=int((t2 - t1) * 1e6),
                   parquet_scan_put_us=int((time.perf_counter() - t2) * 1e6))
        return {c: dev[off: off + nbytes].view(tdtypes[c])
                for c, (off, nbytes) in layout.items()}

    unit_chunks = [local_units[i: i + unit_batch]
                   for i in range(0, len(local_units), unit_batch)]
    # units cycle over the devices
    thunks = (partial(load, ch, devs[i % len(devs)])
              for i, ch in enumerate(unit_chunks))
    auto = ctx.config.prefetch_auto if auto_prefetch is None else auto_prefetch
    max_depth = None
    if auto:
        # bound by what the slab pool can stage per in-flight chunk: the
        # gathered and the packed bytes of the LARGEST chunk (LPT makes
        # sizes near-uniform)
        unit_bytes = max((sum(sizes[(s, g)] + sum(
            _align(s.metadata.row_group(g).num_rows * dtypes[c].itemsize)
            for c in columns) for (s, g) in ch)
            for ch in unit_chunks), default=0)
        max_depth = bound_depth(ctx.config.slab_pool_bytes, unit_bytes,
                                cap=ctx.config.prefetch_max_depth)
    pf = Prefetcher(thunks, depth=prefetch_depth, auto_depth=auto,
                    max_depth=max_depth)
    acc = None
    try:
        for cols in pf:
            part = _tree_map(lambda x: x.to(devs[0], non_blocking=True)
                             if isinstance(x, torch.Tensor) else x,
                             map_fn(cols))
            acc = part if acc is None else _tree_map(_add, acc, part)
    finally:
        # stop feeding BEFORE tearing the decode pool down: an in-flight
        # prefetch thunk submitting to a shut-down pool would raise into a
        # never-consumed future
        pf.close()
        if decode_pool is not None:
            decode_pool.shutdown(wait=True)
    ctx._count(parquet_scan_units=len(local_units),
               parquet_scan_data_stalls=pf.data_stall_steps)
    if acc is None:
        # this process drew zero units: map_fn of zero-length columns in
        # the schema's dtypes, zeroed, so the structure is the same
        empty = {c: torch.zeros(0, dtype=tdtypes[c], device=devs[0])
                 for c in columns}
        acc = _tree_map(_zero, map_fn(empty))
    if not _mesh.is_initialized():
        return _to_host(acc)
    if reduce == "collective":
        return _to_host(_collective_sum(acc))
    return _allgather_sum(_to_host(acc))


def parquet_count_where(ctx: StromContext, paths: Sequence[str],
                        column: str, where_fn: Callable[[Any], Any],
                        **kw: Any) -> int:
    """SELECT count(*) WHERE where_fn(column): the canonical PG-Strom scan
    shape. A declarative ``predicate=`` keyword additionally pushes the
    filter into the plan; *where_fn* still runs on whatever rows survive,
    so passing both the IR form and its callable twin yields the identical
    count with refuted groups never read."""

    def map_fn(cols: dict) -> Any:
        return where_fn(cols[column]).sum()

    return int(parquet_scan_aggregate(ctx, paths, [column], map_fn, **kw))
