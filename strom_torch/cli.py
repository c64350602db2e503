"""strom-torch-bench — the port's benchmark CLI (``python -m strom_torch.cli``
or the ``strom-torch-bench`` script), the counterpart of ``strom/cli.py``.

Every subcommand of the reference, with its flags, defaults and JSON keys.
The deliberate differences:

- ``ssd2tpu`` is ``ssd2gpu`` here (``memcpy_ssd2gpu``; ``"bench":
  "ssd2gpu"``);
- every arm that delivers to a device takes ``--device`` (default: the
  current CUDA device; without one the arm raises — ``--device cpu`` runs
  it on the CPU, as the tests do);
- ``llama``, ``resnet``, ``vit`` and the vision tenants of
  ``multitenant`` are data-parallel over the process group where one is
  initialised (one process a card: ``python -m torch.distributed.run
  --standalone --nproc-per-node N -m strom_torch.cli resnet ...``; rank 0
  prints the JSON): the batch is split over every process, and a world
  size that does not divide ``--batch`` is refused, where the reference
  takes the largest device count that divides it. Without a group, and
  in the other arms, one device; the ``devices`` key says which;
- ``tune`` adds ``searched_items_per_s`` and ``searched_vs_hand``: the
  searched knobs' own rate in the final A/B, before a losing search is
  replaced by the hand knobs;
- ``--engine uring`` raises where no ring can be made (io_uring ENOSYS): it
  never falls back to the preadv pool.
- ``dist --mode mesh`` runs one worker process a card over
  ``torch.distributed`` (``memcpy_ssd2gpu(sharding=)``), where the
  reference's workers each address ``--devices-per-proc`` devices through
  ``jax.distributed``: a ``--devices-per-proc`` other than 1 raises, and
  so does mesh mode without CUDA.

- ``nvme``: O_DIRECT sequential read, block-size chunks into host RAM (the
  raw NVMe read bandwidth);
- ``ssd2gpu``: async ``memcpy_ssd2gpu`` copies kept in flight at
  ``--prefetch``, delivered GB/s.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import threading
import time

import numpy as np


def _mk_testfile(path: str, size: int) -> None:
    """Create a benchmark file of *size* bytes (incompressible-ish pattern)."""
    rng = np.random.default_rng(0)
    block = 8 * 1024 * 1024
    with open(path, "wb") as f:
        remaining = size
        while remaining > 0:
            take = min(block, remaining)
            f.write(rng.integers(0, 256, size=take, dtype=np.uint8).tobytes())
            remaining -= take
    os.sync()


def _drop_cache_hint(path: str) -> None:
    """fsync + posix_fadvise(DONTNEED), so repeated runs read the media and
    not the page cache (a freshly written fixture's pages are dirty and
    would otherwise stay)."""
    from strom_torch.probe.residency import drop_cache

    drop_cache(path)


def _device(args: argparse.Namespace):
    """The arm's target: ``--device``, else the current CUDA device (raises
    without one)."""
    from strom_torch.delivery.core import resolve_device

    return resolve_device(getattr(args, "device", None))


def bench_nvme(args: argparse.Namespace) -> dict:
    """O_DIRECT sequential read, block-size chunks into host RAM."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.buffers import alloc_aligned
    from strom_torch.engine import make_engine

    path = args.file
    created = False
    if path is None:
        path = os.path.join(args.tmpdir, "strom_bench_nvme.bin")
        if not os.path.exists(path) or os.path.getsize(path) < args.size:
            _mk_testfile(path, args.size)
        created = True
    size = min(os.path.getsize(path), args.size) // args.block * args.block
    # from_env: STROM_* overrides stay honoured (STROM_RESIDENCY_HYBRID=0
    # for the --warm A/B, STROM_ENGINE_RINGS for multi-ring runs)
    cfg = StromConfig.from_env(engine=args.engine, block_size=args.block,
                               queue_depth=args.depth,
                               num_buffers=max(args.depth * 2, 8),
                               sqpoll=getattr(args, "sqpoll", False))
    numa_node = getattr(args, "numa_node", -1)
    na = None
    if numa_node >= 0:
        from strom_torch.utils.numa import NumaAffinity

        na = NumaAffinity(node=numa_node)
        na.ensure_thread(path)
    warm = bool(getattr(args, "warm", False))
    results = []
    for it in range(args.iters):
        if warm:
            # the residency hybrid's A/B arm: the page cache warmed, so the
            # engine serves the file as memcpys (the counters prove it)
            with open(path, "rb", buffering=0) as f:
                while f.read(64 * 1024 * 1024):
                    pass
        else:
            _drop_cache_hint(path)
        eng = make_engine(cfg)
        fi = eng.register_file(path, o_direct=not args.buffered)
        dest = alloc_aligned(size, huge=getattr(args, "huge", False))
        if na is not None:
            na.bind(dest)
        eng.register_dest(dest)  # READ_FIXED where supported
        t0 = time.perf_counter()
        if getattr(args, "per_op", False):
            # one submit and wait round trip a block
            n = eng.read_into_direct(fi, 0, size, dest)
        else:
            # the vectored gather: batched submissions at queue depth
            n = eng.read_vectored([(fi, 0, 0, size)], dest)
        dt = time.perf_counter() - t0
        stats = eng.stats()
        eng.close()
        assert n == size
        results.append(size / dt / 1e9)
        if not args.json:
            print(f"  iter {it}: {size / dt / 1e9:.3f} GB/s "
                  f"({size >> 20} MiB in {dt:.3f}s, o_direct="
                  f"{stats.get('unaligned_fallback_reads', 0) == 0})",
                  file=sys.stderr)
    gbps = max(results)
    out = {
        "bench": "nvme", "gbps": round(gbps, 4), "block": args.block,
        "depth": args.depth, "bytes": size, "engine": cfg.engine,
        "o_direct": not args.buffered, "iters": args.iters,
        "per_op": bool(getattr(args, "per_op", False)),
        "numa_node": numa_node,
        "huge": bool(getattr(args, "huge", False)),
        # the engine's ACTIVE state: SQPOLL falls back when refused
        "sqpoll": bool(stats.get("sqpoll", False)),
        "warm": warm,
        "cached_bytes": int(stats.get("cached_bytes", 0)),
        "media_bytes": int(stats.get("media_bytes", 0)),
        "file_created": created,
    }
    out.update(_sqpoll_ab(cfg, path, size, args))
    return out


def _sqpoll_ab(cfg, path: str, size: int, args: argparse.Namespace) -> dict:
    """The SQPOLL submission-syscall A/B: one bounded gather each on a
    plain ring and an SQPOLL ring, submit-side ``io_uring_enter`` calls per
    GB from the engine's counters. Emitted only where an io_uring engine
    ran (``auto`` resolved to the preadv pool reports nothing);
    ``sqpoll_active=0`` marks a kernel that refused SQPOLL."""
    from strom_torch.delivery.buffers import alloc_aligned
    from strom_torch.engine import make_engine

    if cfg.engine not in ("uring", "auto") or getattr(args, "buffered",
                                                      False):
        return {}
    n = min(size, 256 * 1024 * 1024) // cfg.block_size * cfg.block_size
    if n <= 0:
        return {}
    out: dict = {}
    try:
        for key, sqpoll in (("plain_submit_syscalls_per_gb", False),
                            ("sqpoll_submit_syscalls_per_gb", True)):
            _drop_cache_hint(path)
            eng = make_engine(dataclasses.replace(cfg, sqpoll=sqpoll))
            try:
                fi = eng.register_file(path, o_direct=True)
                dest = alloc_aligned(n)
                eng.register_dest(dest)
                got = eng.read_vectored([(fi, 0, 0, n)], dest)
                s = eng.stats()
            finally:
                eng.close()
            if got != n:
                return {}
            calls = int(s.get("enter_submit_calls", 0))
            if not sqpoll and calls == 0:
                # the preadv pool: no syscall counters to compare
                return {}
            out[key] = round(calls * 1e9 / n, 2)
            if sqpoll:
                out["sqpoll_active"] = int(bool(s.get("sqpoll", False)))
    except Exception as e:  # noqa: BLE001 - an optional measurement beside the headline: a host that cannot run it says so on stderr and emits no fields
        print(f"  sqpoll A/B skipped: {e}", file=sys.stderr)
        return {}
    return out


def bench_ssd2host(args: argparse.Namespace) -> dict:
    """The delivered path's host ratio: a bare engine read against
    ``StromContext.memcpy_ssd2host`` (plan, striped-alias resolution,
    extent-aware chunking, residency routing, the engine gather, assembly)
    into the SAME registered dest. The arms alternate which goes first,
    best of N each, so the disk's drift lands on neither.

    ``--raid N`` stripes the file over N members: the delivered arm reads
    through the striped alias, the raw arm reads each member contiguously
    through a bare engine (the same bytes with none of the stripe math)."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.buffers import alloc_aligned
    from strom_torch.delivery.core import StromContext
    from strom_torch.engine import make_engine
    from strom_torch.utils.stats import global_stats as _gs

    path = args.file
    if path is None:
        path = os.path.join(args.tmpdir, "strom_bench_nvme.bin")
        if not os.path.exists(path) or os.path.getsize(path) < args.size:
            _mk_testfile(path, args.size)
    raid = int(getattr(args, "raid", 0) or 0)
    raid_chunk = int(getattr(args, "raid_chunk", 512 * 1024) or 512 * 1024)
    if raid:
        members, _ = _ensure_striped(path, raid, raid_chunk)
        stripe_w = raid * raid_chunk
        size = min(os.path.getsize(path), args.size) // stripe_w * stripe_w
        per_member = size // raid
        drop_paths = members
    else:
        members = []
        size = min(os.path.getsize(path), args.size) // args.block * args.block
        drop_paths = [path]
    cfg = StromConfig.from_env(engine=args.engine, block_size=args.block,
                               queue_depth=args.depth,
                               num_buffers=max(args.depth * 2, 8),
                               **_obs_config_kw(args))
    raw_passes: list[float] = []
    host_passes: list[float] = []
    dest = alloc_aligned(size)
    ctx = StromContext(cfg)
    # the process-wide window counter, as a delta: other arms of one
    # process share it
    _win0 = _gs.counter("stripe_windows").value
    try:
        ctx.engine.register_dest(dest)
        source: str | object = path
        if raid:
            source = path + ".raid0"  # an alias only: never on disk
            ctx.register_striped(source, members, raid_chunk, size=size)

        def run_raw() -> None:
            eng = make_engine(cfg)
            try:
                if raid:
                    ops = [(eng.register_file(m, o_direct=True), 0,
                            i * per_member, per_member)
                           for i, m in enumerate(members)]
                else:
                    ops = [(eng.register_file(path, o_direct=True), 0, 0,
                            size)]
                eng.register_dest(dest)
                t0 = time.perf_counter()
                n = eng.read_vectored(ops, dest)
                dt = time.perf_counter() - t0
            finally:
                eng.close()
            assert n == size
            raw_passes.append(size / dt / 1e9)

        def run_host() -> None:
            t0 = time.perf_counter()
            arr = ctx.memcpy_ssd2host(source, length=size, out=dest)
            dt = time.perf_counter() - t0
            assert arr.nbytes == size
            host_passes.append(size / dt / 1e9)

        # an even pass count: an odd one gives one arm more first places
        passes = max(args.iters, 1)
        if passes % 2:
            passes += 1
            print(f"ssd2host: rounding --iters up to {passes} "
                  f"(alternating arm order needs an even pass count)",
                  file=sys.stderr)
        for i in range(passes):
            for run in ((run_raw, run_host) if i % 2 == 0
                        else (run_host, run_raw)):
                for p in drop_paths:
                    _drop_cache_hint(p)
                run()
            if not args.json:
                print(f"  pass {i}: raw {max(raw_passes):.3f} / host "
                      f"{max(host_passes):.3f} GB/s (best so far)",
                      file=sys.stderr)
        sched = ctx.stats()["context"]
    finally:
        ctx.close()
    raw_gbps = max(raw_passes, default=0.0)
    host_gbps = max(host_passes, default=0.0)
    return {
        "bench": "ssd2host",
        "raw_gbps": round(raw_gbps, 4),
        "host_gbps": round(host_gbps, 4),
        "vs_raw": round(host_gbps / raw_gbps, 4) if raw_gbps else 0.0,
        "raw_gbps_passes": [round(g, 4) for g in raw_passes],
        "host_gbps_passes": [round(g, 4) for g in host_passes],
        "bytes": size, "block": args.block, "depth": args.depth,
        "passes": passes, "engine": cfg.engine,
        "raid_members": raid,
        "coalesce_ops_in": sched["coalesce_ops_in_last"],
        "coalesce_ops_out": sched["coalesce_ops_out_last"],
        "stripe_overlap_window_bytes": sched["stripe_overlap_window_bytes"],
        "stripe_windows": sched["stripe_windows"] - _win0,
    }


def bench_ssd2gpu(args: argparse.Namespace) -> dict:
    """Async ``memcpy_ssd2gpu`` copies kept in flight; delivered GB/s."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext

    path = args.file
    if path is None:
        path = os.path.join(args.tmpdir, "strom_bench_nvme.bin")
        if not os.path.exists(path) or os.path.getsize(path) < args.size:
            _mk_testfile(path, args.size)
    size = min(os.path.getsize(path), args.size)
    chunk = args.chunk
    n_chunks = size // chunk
    size = n_chunks * chunk
    dev = _device(args)

    cfg = StromConfig(engine=args.engine, block_size=args.block,
                      queue_depth=args.depth, num_buffers=max(args.depth * 2, 8),
                      prefetch_depth=args.prefetch, delivery_workers=args.prefetch,
                      **_obs_config_kw(args))
    results = []
    for it in range(args.iters):
        _drop_cache_hint(path)
        ctx = StromContext(cfg)
        try:
            # one transfer outside the timed region (pool, streams)
            warm = ctx.memcpy_ssd2gpu(path, offset=0, length=chunk,
                                      device=dev)
            _fetch_one(warm)
            del warm
            _drop_cache_hint(path)
            t0 = time.perf_counter()
            inflight = []
            delivered = []
            for i in range(n_chunks):
                h = ctx.memcpy_ssd2gpu(path, offset=i * chunk, length=chunk,
                                       device=dev, async_=True)
                inflight.append(h)
                if len(inflight) > args.prefetch:
                    delivered.append(inflight.pop(0).result())
            for h in inflight:
                delivered.append(h.result())
            if delivered:  # n_chunks is 0 when the file is < one chunk
                _fetch_one(delivered[-1])
            dt = time.perf_counter() - t0
            del delivered
        finally:
            ctx.close()
        results.append(size / dt / 1e9)
        if not args.json:
            print(f"  iter {it}: {size / dt / 1e9:.3f} GB/s into {dev}",
                  file=sys.stderr)
    gbps = max(results)
    return {
        "bench": "ssd2gpu", "gbps": round(gbps, 4), "chunk": chunk,
        "block": args.block, "depth": args.depth, "prefetch": args.prefetch,
        "bytes": size, "engine": cfg.engine, "iters": args.iters,
        "device": str(dev),
    }


def _ensure_striped(plain: str, raid: int, chunk: int) -> tuple[list[str], int]:
    """(member files, true size) of *plain* striped RAID0-style. Member
    names carry both raid knobs, and a fingerprint sidecar (source size
    and mtime_ns, written last) restripes a changed source."""
    from strom_torch.engine.raid0 import stripe_file

    members = [f"{plain}.r{i}of{raid}.c{chunk}" for i in range(raid)]
    st = os.stat(plain)
    fingerprint = f"{st.st_size}:{st.st_mtime_ns}"
    fp_path = members[0] + ".stromfp"
    try:
        with open(fp_path) as f:
            fresh = f.read() == fingerprint \
                and all(os.path.exists(m) for m in members)
    except OSError:
        fresh = False
    if not fresh:
        stripe_file(plain, members, chunk)
        with open(fp_path, "w") as f:
            f.write(fingerprint)
    return members, st.st_size


def _fetch_one(arr) -> None:
    """Wait until *arr* has arrived: an event recorded on the stream the
    tensor is ordered on, after it, then that event's wait (the rest of the
    card keeps running). Nothing to wait for on the CPU."""
    import torch

    if isinstance(arr, torch.Tensor) and arr.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(arr.device))
        ev.synchronize()


def _fit_dp_devices(batch: int) -> int:
    """The processes (one card each) the batch is split over: the group's
    size where one is initialised, else 1. A size that does not divide
    *batch* raises ValueError."""
    from strom_torch.parallel import mesh

    if not mesh.is_initialized():
        return 1
    n = mesh.world_size()
    if batch % n:
        raise ValueError(f"--batch {batch} does not split over {n} processes")
    return n


def _rank0_first(make) -> None:
    """Run *make* (a fixture's writer) on rank 0 only, the others waiting
    at a barrier until it has; *make* alone without a group. Every rank
    calls this unconditionally: whether a fixture is missing is decided
    inside *make*, on rank 0, since a rank that looked for itself could
    find rank 0's finished file and skip the barrier rank 0 waits at."""
    from strom_torch.parallel import mesh

    if mesh.rank() == 0:
        make()
    if mesh.is_initialized():
        import torch.distributed as dist

        dist.barrier(group=mesh.host_group())


def _made_once(make):
    """*make()*'s result on every rank: rank 0 makes it first, the others
    then find what it made (a fixture's writer that returns its path)."""
    out: list = []
    _rank0_first(lambda: out.append(make()))
    return out[0] if out else make()


def _vision_where(batch: int, dev) -> tuple[int, dict]:
    """(devices, the vision pipelines' placement keyword): with a process
    group the batch is ``P("dp", None, None, None)`` over a dp mesh of
    every process (each decodes its own rows onto its own card), else the
    whole batch on *dev*. A world that does not divide *batch* raises."""
    from strom_torch.parallel.mesh import is_initialized, make_mesh
    from strom_torch.parallel.sharding import P, TorchSharding

    n_dev = _fit_dp_devices(batch)
    if not is_initialized():
        return n_dev, {"device": dev}
    mesh = make_mesh({"dp": n_dev})
    return n_dev, {"sharding": TorchSharding(mesh, P("dp", None, None, None))}


def _timed_train_phase(pipe_factory, step, steps: int,
                       items_per_step: int
                       ) -> tuple[float, int, float, dict]:
    """The shared train phase of llama, resnet and vit: two warm-up steps
    outside the timed region (a captured step runs eagerly on its first
    call and captures its graph on the second, where the reference's jit
    compiles on its first), a stall-counter baseline, *steps* timed
    steps, then the loss read to the host (the step chain has finished
    when it arrives).

    *step(batch) -> loss* keeps the model state in its closure. Returns
    (items_per_s, data_stall_steps, final_loss, depth_info): the prefetch
    depth at the end, its (step, depth) trace and the per-step stall
    attribution of the event ring (goodput and the buckets' p50/p99)."""
    from strom_torch.obs import stall
    from strom_torch.obs.events import ring

    with pipe_factory() as pipe:
        for _ in range(2):   # warm-up; the reported loss at steps=0
            loss = step(next(pipe))
        float(loss)
        base_stalls = pipe.data_stall_steps
        ring_lo = ring.now_us()  # attribute only this phase's steps
        t0 = time.perf_counter()
        for i in range(steps):
            # one consumer step = one next() and the compute consuming it
            with ring.span("train.step", cat="step", args={"step": i}):
                loss = step(next(pipe))
        train_loss = float(loss)
        dt = time.perf_counter() - t0
        depth_info = {
            "prefetch_depth_final": pipe.prefetch_depth,
            "prefetch_depth_trace": pipe.prefetch_depth_trace,
        }
        depth_info.update(stall.flatten_summary(stall.steps_summary(
            ring.snapshot(), lo_us=ring_lo, hi_us=ring.now_us())))
        return (round(steps * items_per_step / dt, 1),
                pipe.data_stall_steps - base_stalls, round(train_loss, 4),
                depth_info)


def _bounded_train_phase(pipe_factory_at_depth, step, rate: float,
                         items_per_step: int, bsteps: int, bdepth: int
                         ) -> tuple[float, int, float]:
    """The paced arm: after each step the consumer waits about one
    measured step time (*items_per_step* / *rate*, within [0.01, 1] s), so
    a shallow queue (depth *bdepth*) must keep up with a consumer that
    runs at the step's own pace. Returns (items_per_s, data_stall_steps,
    delay_s)."""
    delay = items_per_step / rate if rate else 0.05
    delay = min(max(delay, 0.01), 1.0)

    def paced(batch):
        loss = step(batch)
        time.sleep(delay)
        return loss

    r, stalls, _, _ = _timed_train_phase(lambda: pipe_factory_at_depth(bdepth),
                                         paced, bsteps, items_per_step)
    return r, stalls, round(delay, 4)


def _run_bounded_arm(args: argparse.Namespace, out: dict, pipe_factory, step,
                     rate: float, items_per_step: int, rate_key: str,
                     drop_paths) -> None:
    """Run the paced arm when --bounded-steps asks for it and record its
    keys (one place for the llama, resnet and vit arms)."""
    bsteps = int(getattr(args, "bounded_steps", 0) or 0)
    if not bsteps:
        return
    bdepth = int(getattr(args, "bounded_prefetch", 4) or 4)
    for p in drop_paths:
        _drop_cache_hint(p)
    brate, bstalls, delay = _bounded_train_phase(
        pipe_factory, step, rate, items_per_step, bsteps, bdepth)
    out["bounded_train_data_stalls"] = bstalls
    out["bounded_steps"] = bsteps
    out["bounded_prefetch"] = bdepth
    out["bounded_step_delay_s"] = delay
    out[rate_key] = brate


def bench_llama(args: argparse.Namespace) -> dict:
    """The packed-token loader's tokens/s and data-stall count, in two
    phases:

    1. the loader flat out, each batch consumed at once (loader rate);
    2. with --train-step, the captured Llama train step of
       ``parallel/train.py`` consumes the batches: the loader must hide
       its I/O behind the step.

    With a process group the batch is ``P("dp", None)`` over a dp mesh of
    every process (each reads its own rows onto its own card) and the step
    is data-parallel; without one, one device."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.parallel.mesh import is_initialized, make_mesh
    from strom_torch.parallel.sharding import P, TorchSharding, local_tensor
    from strom_torch.pipelines import make_llama_pipeline

    record = (args.seq_len + 1) * 4
    path = args.file
    if path is None:
        path = os.path.join(args.tmpdir, "strom_bench_tokens.bin")
        want = args.steps * args.batch * record * 2

        def make() -> None:
            if not os.path.exists(path) or os.path.getsize(path) < want:
                _mk_testfile(path, want)

        _rank0_first(make)
    dev = _device(args)
    cfg = StromConfig(engine=args.engine, block_size=args.block,
                      queue_depth=args.depth, num_buffers=max(args.depth * 2, 8),
                      **_obs_config_kw(args))
    ctx = StromContext(cfg)
    try:
        n_dev = _fit_dp_devices(args.batch)
        mesh = make_mesh({"dp": n_dev}) if is_initialized() else None
        where = {"device": dev} if mesh is None else \
            {"sharding": TorchSharding(mesh, P("dp", None))}
        _drop_cache_hint(path)
        with make_llama_pipeline(ctx, [path], batch=args.batch,
                                 seq_len=args.seq_len,
                                 prefetch_depth=args.prefetch,
                                 **where) as pipe:
            toks = next(pipe)  # warm-up outside the timed region
            _fetch_one(toks)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                toks = next(pipe)
            if args.steps:
                _fetch_one(toks)
            dt = time.perf_counter() - t0
            stalls = pipe.data_stall_steps
        tokens = args.steps * args.batch * (args.seq_len + 1)
        out = {
            "bench": "llama_loader", "tokens_per_s": round(tokens / dt, 1),
            "gbps": round(tokens * 4 / dt / 1e9, 4), "batch": args.batch,
            "seq_len": args.seq_len, "steps": args.steps, "devices": n_dev,
            "data_stall_steps": stalls, "engine": cfg.engine,
        }

        if getattr(args, "train_step", False):
            from strom_torch.models.llama import LlamaConfig
            from strom_torch.parallel.train import (init_train_state,
                                                    make_optimizer,
                                                    make_train_step)

            mcfg = getattr(LlamaConfig, args.model)()
            opt = make_optimizer()
            state = init_train_state(mcfg, opt, device=dev, seed=0,
                                     mesh=mesh)
            step_fn = make_train_step(mcfg, opt, attn=args.attn, device=dev,
                                      mesh=mesh)

            def step(toks):
                nonlocal state
                # bench tokens are random bytes: clamped into the vocab
                state, m = step_fn(state, local_tensor(toks) % mcfg.vocab)
                return m["loss"]

            auto = bool(getattr(args, "auto_prefetch", False))
            rate, stalls, loss, dinfo = _timed_train_phase(
                lambda: make_llama_pipeline(ctx, [path], batch=args.batch,
                                            seq_len=args.seq_len,
                                            prefetch_depth=args.prefetch,
                                            auto_prefetch=auto, **where),
                step, args.steps, args.batch * (args.seq_len + 1))
            out["train_tokens_per_s"] = rate
            out["train_data_stalls"] = stalls
            out["train_model"] = args.model
            out["train_attn"] = args.attn
            out["train_loss"] = loss
            out["prefetch_auto"] = auto
            out.update(dinfo)

            _run_bounded_arm(
                args, out,
                lambda depth: make_llama_pipeline(
                    ctx, [path], batch=args.batch, seq_len=args.seq_len,
                    prefetch_depth=depth, **where),
                step, rate, args.batch * (args.seq_len + 1),
                "bounded_train_tokens_per_s", [path])
    finally:
        ctx.close()
    return out


def _mk_wds_fixture(tmpdir: str, batch: int, image_size: int) -> str:
    """A WebDataset .tar of random JPEGs (named by both knobs, so a bigger
    --batch makes a new one), shared by the vision arms."""
    import io
    import tarfile

    n_samples = max(batch * 4, 256)
    path = os.path.join(tmpdir, f"strom_bench_wds_{image_size}_{n_samples}.tar")
    if not os.path.exists(path):
        import cv2

        rng = np.random.default_rng(0)
        with tarfile.open(path, "w") as tf:
            for i in range(n_samples):
                img = rng.integers(0, 256, (image_size * 2, image_size * 2, 3),
                                   dtype=np.uint8)
                ok, buf = cv2.imencode(".jpg", img,
                                       [cv2.IMWRITE_JPEG_QUALITY, 90])
                assert ok
                for name, data in ((f"s{i:06d}.jpg", buf.tobytes()),
                                   (f"s{i:06d}.cls", str(i % 1000).encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        os.sync()
    return path


def _ensure_predecoded(ctx, tar_path: str, image_size: int, tmpdir: str) -> str:
    """The --predecoded arm's fixture: the tar decoded once into a packed
    uint8 shard, made again when the source's fingerprint changes."""
    from strom_torch.formats.predecoded import LABELS_SUFFIX, predecode_wds

    st = os.stat(tar_path)
    out = os.path.join(
        tmpdir, f"{os.path.basename(tar_path)}.{image_size}.pdec")
    fingerprint = f"{st.st_size}:{st.st_mtime_ns}:{image_size}"
    fp_path = out + ".srcfp"
    try:
        with open(fp_path) as f:
            if f.read() == fingerprint and os.path.exists(out) \
                    and os.path.exists(out + LABELS_SUFFIX):
                return out
    except OSError:
        pass
    predecode_wds(ctx, [tar_path], out, image_size=image_size)
    with open(fp_path, "w") as f:
        f.write(fingerprint)
    return out


# decode counters of the JPEG vision arms: reduced-scale hits per
# denominator, bytes decoded straight into batch slots, zero-image
# substitutions, the decode/put overlap window
_DECODE_COUNTERS = ("decode_reduced_hits_2", "decode_reduced_hits_4",
                    "decode_reduced_hits_8", "decode_slot_bytes",
                    "decode_errors", "decode_put_overlap_ms")


def _hist_delta(snap0: dict, snap1: dict, stem: str) -> tuple[float, float]:
    """(p50_us, mean_us) of histogram *stem* over the snapshot delta, for
    the decode and stream columns alike."""
    from strom_torch.utils.stats import percentile_from_buckets

    b0 = snap0.get(stem + "_hist") or []
    b1 = snap1.get(stem + "_hist") or []
    db = [a - b for a, b in zip(b1, b0)] if b0 else list(b1)
    n = sum(db)

    def _tot(snap: dict) -> float:
        t = snap.get(stem + "_total_us")
        if t is None:
            t = snap.get(stem + "_mean_us", 0.0) \
                * snap.get(stem + "_count", 0)
        return t

    tot = _tot(snap1) - _tot(snap0)
    return (percentile_from_buckets(db, 0.50),
            round(tot / n, 1) if n else 0.0)


def _decode_stats_delta(snap0: dict) -> dict:
    """The decode counters and histogram since *snap0* (the registry is
    process-wide and shared by the arms of one process)."""
    from strom_torch.utils.stats import global_stats

    snap1 = global_stats.snapshot()
    out = {k: int(snap1.get(k, 0) - snap0.get(k, 0))
           for k in _DECODE_COUNTERS}
    p50, mean = _hist_delta(snap0, snap1, "decode_batch")
    out["decode_batch_p50_us"] = p50
    out["decode_batch_mean_us"] = mean
    return out


def _decode_config_kw(args: argparse.Namespace) -> dict:
    """StromConfig decode knobs from the A/B flags (absent in a
    hand-built Namespace: the config's defaults, all on)."""
    return {
        "decode_reduced_scale": not getattr(args, "full_decode", False),
        "decode_to_slot": not getattr(args, "no_slot_decode", False),
        "decode_overlap_put": not getattr(args, "no_overlap_put", False),
        # --no-stream restores the gather-all, decode-all, put-all barrier
        # path (the same batches); an explicit --stream wins
        "stream_intra_batch": bool(getattr(args, "stream", False))
        or not getattr(args, "no_stream", False),
        "decode_native": not getattr(args, "no_native_decode", False),
        "decode_fuse_runs": not getattr(args, "no_fuse_decode", False),
        "decode_roi": not getattr(args, "no_roi_decode", False),
        "decode_cache": bool(getattr(args, "decode_cache", False)),
    }


def _stream_stats_begin() -> None:
    """Zero the stream peak gauge where an arm takes its baseline: a max
    cannot be taken as a delta."""
    from strom_torch.utils.stats import global_stats

    global_stats.set_gauge("stream_inflight_peak", 0)


def _stream_stats_delta(snap0: dict) -> dict:
    """The streamed path's counters and histograms since *snap0*;
    ``stream_inflight_peak`` is this arm's peak (zeroed at its start)."""
    from strom_torch.utils.stats import global_stats

    snap1 = global_stats.snapshot()
    out = {k: int(snap1.get(k, 0) - snap0.get(k, 0))
           for k in ("stream_batches", "stream_instant_bytes",
                     "stream_samples_early")}
    out["stream_inflight_peak"] = int(snap1.get("stream_inflight_peak", 0))
    for stem in ("stream_first_decode_lat", "stream_tail_extent"):
        p50, mean = _hist_delta(snap0, snap1, stem)
        out[stem + "_p50_us"] = p50
        out[stem + "_mean_us"] = mean
    return out


def _req_slo_delta(ctx, snap0: dict) -> dict:
    """An arm's request latency p50/p99 (the ``req_lat`` histogram over the
    delta) and the SLO verdict (1 = no tenant burning at the arm's end)."""
    from strom_torch.utils.stats import global_stats, percentile_from_buckets

    snap1 = global_stats.snapshot()
    b0 = snap0.get("req_lat_hist") or []
    b1 = snap1.get("req_lat_hist") or []
    db = [a - b for a, b in zip(b1, b0)] if b0 else list(b1)
    return {
        "req_lat_p50_us": percentile_from_buckets(db, 0.50),
        "req_lat_p99_us": percentile_from_buckets(db, 0.99),
        "slo_ok": int(ctx.slo.ok()),
    }


def _obs_config_kw(args: argparse.Namespace) -> dict:
    """StromConfig observability knobs from the common flags (absent in a
    hand-built Namespace: off): the live endpoint, the flight recorder,
    a fault plan and the lock-order witness."""
    return {"metrics_port": int(getattr(args, "metrics_port", 0) or 0),
            "flight_dir": getattr(args, "flight_dir", "") or "",
            "flight_stall_s":
                float(getattr(args, "flight_stall_s", 30.0) or 0.0),
            "fault_plan": getattr(args, "fault_plan", "") or "",
            "debug_locks": bool(getattr(args, "debug_locks", False))}


def _resil_delta(snap0: dict) -> dict:
    """The resilience counters (``RESILIENCE_FIELDS``) since *snap0*;
    ``breaker_state`` is a live gauge, read as it is."""
    from strom_torch.engine.resilience import RESILIENCE_FIELDS
    from strom_torch.utils.stats import global_stats

    snap1 = global_stats.snapshot()
    out = {}
    for k in RESILIENCE_FIELDS:
        if k == "breaker_state":
            out[k] = int(snap1.get(k, 0))
        else:
            out[k] = int(snap1.get(k, 0) - snap0.get(k, 0))
    return out


def _cache_config_kw(args: argparse.Namespace) -> dict:
    """StromConfig hot-cache knobs from the --hot-cache flags (absent in a
    hand-built Namespace: the cache off)."""
    hc = 0 if getattr(args, "no_hot_cache", False) \
        else int(getattr(args, "hot_cache_bytes", 0) or 0)
    return {
        "hot_cache_bytes": hc,
        "hot_cache_admit": getattr(args, "hot_cache_admit", None)
        or "second_touch",
        "readahead_window_batches":
            int(getattr(args, "readahead_window", 0) or 0) if hc else 0,
    }


def _flat_epoch(pipe_factory, batch: int, drop_paths, *,
                steady: bool = False, **pkw) -> tuple[float, int]:
    """One flat-out epoch's (img/s, steps): page cache dropped, one epoch
    of batches, the last one waited for. *steady* runs one epoch first so
    the timed one excludes the pipeline's construction; *pkw* are the
    pipeline's knob overrides."""
    for p in drop_paths:
        _drop_cache_hint(p)
    with pipe_factory(**pkw) as pipe:
        spe = pipe.sampler.batches_per_epoch
        imgs = None
        if steady:
            for _ in range(spe):
                imgs, _ = next(pipe)
            if imgs is not None:
                _fetch_one(imgs)
        t0 = time.perf_counter()
        for _ in range(spe):
            imgs, _ = next(pipe)
        if imgs is not None:
            _fetch_one(imgs)
        dt = time.perf_counter() - t0
    return (spe * batch / dt if dt else 0.0), spe


def _bench_cache_scope(ctx) -> None:
    """The hot cache serves only the cold/warm epoch pair: the flat-out,
    train and paced phases keep reading the disk, so their columns mean
    what they meant without the cache."""
    if ctx.hot_cache is not None:
        ctx.hot_cache.enabled = False


def _cache_epoch_phases(ctx, pipe_factory, batch: int, drop_paths) -> dict:
    """One epoch flat out twice over the same records: the cold pass pays
    the gathers (and the admissions), the warm one is served by the hot
    cache. ``warm_vs_cold`` is the speedup; ``cache_hit_bytes`` and
    ``cache_miss_bytes`` (the warm pass's deltas) say where the bytes came
    from. The page cache is dropped before both passes; the hot cache is
    cleared and enabled for the pair only, and disabled and cleared after."""
    from strom_torch.utils.stats import global_stats as _gs

    if ctx.hot_cache is not None:
        ctx.hot_cache.clear()
        ctx.hot_cache.enabled = True

    def one_epoch() -> tuple[float, int]:
        return _flat_epoch(pipe_factory, batch, drop_paths)

    try:
        snap0 = _gs.snapshot()
        cold, spe = one_epoch()
        snap1 = _gs.snapshot()
        warm, _ = one_epoch()
        snap2 = _gs.snapshot()
    finally:
        if ctx.hot_cache is not None:
            # disabled AND emptied: later phases never hit it, and its
            # entries would only shrink the slab pool under them
            ctx.hot_cache.enabled = False
            ctx.hot_cache.clear()

    def delta(key: str, a: dict, b: dict) -> int:
        return int(b.get(key, 0) - a.get(key, 0))

    return {
        "cold_images_per_s": round(cold, 1),
        "warm_images_per_s": round(warm, 1),
        "warm_vs_cold": round(warm / cold, 3) if cold else None,
        "cache_hit_bytes": delta("cache_hit_bytes", snap1, snap2),
        "cache_miss_bytes": delta("cache_miss_bytes", snap1, snap2),
        "cache_admitted_bytes": delta("cache_admitted_bytes", snap0, snap1),
        "cache_readahead_bytes": delta("cache_readahead_bytes", snap0, snap2),
        "cache_epoch_steps": spe,
    }


def _decode2_phases(ctx, pipe_factory, batch: int, drop_paths) -> dict:
    """Two measurements on the cache pair's fixture and protocol:

    (1) native against cv2: one flat-out epoch with the native
    libjpeg-turbo binding, fused runs and ROI decode forced on, one with
    the three off (``decode_native_vs_cv2``, with the counters that show
    which route decoded). Only where the native binding exists.

    (2) with a hot cache: the decoded-frame cache's cold and warm epochs
    (``decode_cache=True``, the cache scoped to the pair as in
    :func:`_cache_epoch_phases`); the warm epoch pays only crop and
    resize."""
    from strom_torch.formats.jpeg import native_available
    from strom_torch.utils.stats import global_stats as _gs

    def one_epoch(steady: bool = False, **pkw) -> tuple[float, int]:
        return _flat_epoch(pipe_factory, batch, drop_paths, steady=steady,
                           **pkw)

    def delta(key: str, a: dict, b: dict) -> int:
        return int(b.get(key, 0) - a.get(key, 0))

    out: dict = {}
    if native_available():
        snap0 = _gs.snapshot()
        native_rate, _ = one_epoch(decode_native=True,
                                   decode_fuse_runs=True,
                                   decode_roi=True, decode_cache=False)
        snap1 = _gs.snapshot()
        cv2_rate, _ = one_epoch(decode_native=False, decode_fuse_runs=False,
                                decode_roi=False, decode_cache=False)
        out["decode_native_img_per_s"] = round(native_rate, 1)
        out["decode_cv2_img_per_s"] = round(cv2_rate, 1)
        out["decode_native_vs_cv2"] = round(native_rate / cv2_rate, 3) \
            if cv2_rate else None
        for k in ("decode_native_imgs", "decode_native_fallbacks",
                  "decode_fused_runs", "decode_fused_samples",
                  "decode_roi_hits", "decode_roi_rows_skipped"):
            out[k] = delta(k, snap0, snap1)

    if ctx.hot_cache is not None:
        ctx.hot_cache.clear()
        ctx.hot_cache.enabled = True
        try:
            s0 = _gs.snapshot()
            cold, _ = one_epoch(decode_cache=True)
            s1 = _gs.snapshot()
            # steady: the warm number excludes construction, as the
            # flat-out columns do; the cold epoch cannot (it would not be
            # cold then)
            warm, _ = one_epoch(steady=True, decode_cache=True)
            s2 = _gs.snapshot()
        finally:
            ctx.hot_cache.enabled = False
            ctx.hot_cache.clear()
        out["decode_cache_cold_img_per_s"] = round(cold, 1)
        out["decode_cache_warm_img_per_s"] = round(warm, 1)
        out["decode_cache_warm_vs_cold"] = round(warm / cold, 3) \
            if cold else None
        out["decode_cache_hits"] = delta("decode_cache_hits", s1, s2)
        out["decode_cache_hit_bytes"] = delta("decode_cache_hit_bytes",
                                              s1, s2)
        # s0 -> s2: under second_touch the admissions land in the warm pass
        out["decode_cache_admitted_bytes"] = \
            delta("decode_cache_admitted_bytes", s0, s2)
    return out


_DECODE_FLAG_KEYS = ("decode_reduced_scale", "decode_to_slot",
                     "decode_overlap_put", "stream_intra_batch",
                     "decode_native", "decode_fuse_runs", "decode_roi")


def _vision_arm(args: argparse.Namespace, kind: str) -> dict:
    """The resnet and vit arms: one loader flat out, the hot-cache pair,
    the decode pair, and with --train-step the captured train step and the
    paced arm. *kind* ``"resnet"`` reads the tar (or its predecoded shard)
    as it is; ``"vit"`` reads it striped over --raid members."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.pipelines import (make_imagenet_resnet_pipeline,
                                       make_predecoded_vision_pipeline,
                                       make_vit_wds_pipeline)
    from strom_torch.utils.stats import global_stats as _gs

    plain = args.file or _made_once(lambda: _mk_wds_fixture(
        args.tmpdir, args.batch, args.image_size))
    dev = _device(args)
    cfg = StromConfig(engine=args.engine, block_size=args.block,
                      queue_depth=args.depth, num_buffers=max(args.depth * 2, 8),
                      **_decode_config_kw(args), **_obs_config_kw(args),
                      **_cache_config_kw(args))
    ctx = StromContext(cfg)
    _bench_cache_scope(ctx)
    _stream_stats_begin()
    _dec0 = _gs.snapshot()
    try:
        predecoded = bool(getattr(args, "predecoded", False))
        # auto depth is for the train phase only: the paced arm runs a
        # fixed shallow depth by design, the flat-out one has no compute
        auto_pf = bool(getattr(args, "auto_prefetch", False))
        if kind == "vit":
            if predecoded:
                from strom_torch.formats.predecoded import \
                    stage_striped_predecoded

                pdec = _made_once(lambda: _ensure_predecoded(
                    ctx, plain, args.image_size, args.tmpdir))
                members, _ = _made_once(lambda: _ensure_striped(
                    pdec, args.raid, args.raid_chunk))
                virt = stage_striped_predecoded(ctx, pdec, members,
                                                args.raid_chunk, stripe=False)
            else:
                members, _ = _made_once(lambda: _ensure_striped(
                    plain, args.raid, args.raid_chunk))
                virt = plain + ".raid0"  # never on disk: reads via the alias
                ctx.register_striped(virt, members, args.raid_chunk)
            data_paths, drop_paths = [virt], members
            make_jpeg = make_vit_wds_pipeline
        else:
            if predecoded:
                data_paths = [_made_once(lambda: _ensure_predecoded(
                    ctx, plain, args.image_size, args.tmpdir))]
            else:
                data_paths = [plain]
            drop_paths = data_paths
            make_jpeg = make_imagenet_resnet_pipeline
        n_dev, where = _vision_where(args.batch, dev)

        if predecoded:
            def pipe_factory(depth=args.prefetch, auto=False):
                return make_predecoded_vision_pipeline(
                    ctx, data_paths, batch=args.batch,
                    image_size=args.image_size, prefetch_depth=depth,
                    auto_prefetch=auto, **where)
        else:
            def pipe_factory(depth=args.prefetch, auto=False, **pkw):
                return make_jpeg(
                    ctx, data_paths, batch=args.batch,
                    image_size=args.image_size, prefetch_depth=depth,
                    auto_prefetch=auto, decode_workers=args.decode_workers,
                    **where, **pkw)
        for p in drop_paths:
            _drop_cache_hint(p)
        with pipe_factory() as pipe:
            imgs = next(pipe)[0]  # warm-up outside the timed region
            _fetch_one(imgs)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                imgs, _ = next(pipe)
            if args.steps:
                _fetch_one(imgs)
            dt = time.perf_counter() - t0
            stalls = pipe.data_stall_steps
        out = {"bench": f"{kind}_loader",
               "images_per_s": round(args.steps * args.batch / dt, 1),
               "batch": args.batch, "image_size": args.image_size,
               "steps": args.steps, "devices": n_dev}
        if kind == "vit":
            out["raid_members"] = args.raid
        out["data_stall_steps"] = stalls
        if kind == "resnet":
            # the decode-free arm runs no decode pool
            out["decode_workers"] = 0 if predecoded else args.decode_workers
        out["engine"] = cfg.engine
        out["predecoded"] = predecoded
        if not predecoded:
            out.update({k: getattr(cfg, k) for k in _DECODE_FLAG_KEYS})
        if cfg.hot_cache_bytes:
            out["hot_cache_bytes"] = cfg.hot_cache_bytes
            out["hot_cache_admit"] = cfg.hot_cache_admit
            out.update(_cache_epoch_phases(ctx, pipe_factory, args.batch,
                                           drop_paths))
        if not predecoded and not getattr(args, "no_decode2", False):
            out.update(_decode2_phases(ctx, pipe_factory, args.batch,
                                       drop_paths))

        if getattr(args, "train_step", False):
            sharding = where.get("sharding")
            step = _vision_step(args, kind, dev,
                                sharding.mesh if sharding else None)
            for p in drop_paths:
                _drop_cache_hint(p)
            rate, stalls, loss, dinfo = _timed_train_phase(
                lambda: pipe_factory(args.prefetch, auto_pf), step,
                args.steps, args.batch)
            out["train_images_per_s"] = rate
            out["train_data_stalls"] = stalls
            out["train_model"] = args.model
            out["train_loss"] = loss
            out["prefetch_auto"] = auto_pf
            out.update(dinfo)
            # the paced arm at a fixed depth (pipe_factory's auto is False)
            _run_bounded_arm(args, out, pipe_factory, step, rate, args.batch,
                             "bounded_train_images_per_s", drop_paths)
        if not predecoded:
            out.update(_decode_stats_delta(_dec0))
            out.update(_stream_stats_delta(_dec0))
        out.update(_req_slo_delta(ctx, _dec0))
    finally:
        ctx.close()
    return out


def _vision_step(args: argparse.Namespace, kind: str, dev, mesh=None):
    """*batch* -> loss of the captured SGD step of ``parallel/train.py``
    (``w - 1e-3·g``, labels taken modulo the classes): ResNet with its
    batch-norm statistics, or ViT at --image-size. With a dp *mesh* the
    step is data-parallel and every replica starts from the dp group's
    first rank's model."""
    from strom_torch.parallel.train import (make_resnet_sgd_step,
                                            make_vit_sgd_step, replicate)

    if kind == "resnet":
        from strom_torch.models.resnet import ResNet, ResNetConfig

        mcfg = getattr(ResNetConfig, args.model)()
        model = ResNet(mcfg, device=dev)
        sgd = make_resnet_sgd_step(mcfg, device=dev, mesh=mesh)
    else:
        from strom_torch.models.vit import ViT, ViTConfig

        mcfg = getattr(ViTConfig, args.model)()
        if mcfg.image_size != args.image_size:
            mcfg = dataclasses.replace(mcfg, image_size=args.image_size)
        model = ViT(mcfg, device=dev)
        sgd = make_vit_sgd_step(mcfg, device=dev, mesh=mesh)
    if mesh is not None:
        replicate(model, mesh)

    def step(batch):
        imgs, lbls = batch
        return sgd(model, imgs, lbls)["loss"]

    return step


def bench_resnet(args: argparse.Namespace) -> dict:
    """A JPEG WebDataset through decode to the device, images/s; the
    captured ResNet step with --train-step. --predecoded reads a shard the
    tar was decoded into once: each batch is one engine gather."""
    return _vision_arm(args, "resnet")


def bench_vit(args: argparse.Namespace) -> dict:
    """The WebDataset tar striped over --raid members (a path alias: every
    gather stripe-decodes) into the ViT loader; the captured ViT step with
    --train-step. --predecoded stripes the decoded shard instead."""
    return _vision_arm(args, "vit")


def _parquet_devices(args: argparse.Namespace):
    """Where the scan's map runs: ``["cpu"]`` under --cpu-device (the
    reference's host placement) or --device cpu, else the card."""
    if getattr(args, "cpu_device", False):
        return ["cpu"]
    dev = _device(args)
    return [dev]


def _pushdown_ab(ctx, args: argparse.Namespace) -> dict:
    """The same logical scan twice: with the predicate pushed into the plan
    (row groups the statistics refute never enter an ExtentList) and as a
    row filter after the full read. Both must give the same aggregate; the
    pushed one must submit fewer bytes. The fixture's ``seq`` column is
    monotone, so ``seq < cutoff`` refutes exactly the groups past it."""
    from strom_torch.formats.parquet import write_parquet
    from strom_torch.ops.pushdown import PUSHDOWN_FIELDS, col
    from strom_torch.pipelines.parquet_scan import parquet_scan_aggregate
    from strom_torch.utils.stats import global_stats

    rows = min(int(args.rows), 1 << 20)
    groups = max(int(args.row_groups), 8)
    sel = float(getattr(args, "pushdown_selectivity", 0.25) or 0.25)
    sel = min(max(sel, 0.05), 1.0)
    path = os.path.join(args.tmpdir,
                        f"strom_bench_pushdown_{rows}_{groups}.parquet")
    if not os.path.exists(path):
        rng = np.random.default_rng(1)
        write_parquet(ctx, path, {
            "seq": np.arange(rows, dtype=np.int64),
            "value": rng.standard_normal(rows),
            # weight neither arm selects: pruned in both
            "payload": rng.integers(0, 256, rows, dtype=np.int64),
        }, row_group_rows=max(rows // groups, 1), compression="snappy")
    cutoff = int(rows * sel)
    pred = col("seq") < cutoff
    devs = _parquet_devices(args)

    def map_pushed(d: dict):
        return {"hits": (d["value"] > 0).sum()}

    def map_post(d: dict):
        keep = d["seq"] < cutoff
        return {"hits": ((d["value"] > 0) & keep).sum()}

    def pushed() -> int:
        r = parquet_scan_aggregate(ctx, [path], ["value"], map_pushed,
                                   predicate=pred, prefetch_depth=args.prefetch,
                                   unit_batch=1, devices=devs)
        return int(r["hits"])

    def post() -> int:
        r = parquet_scan_aggregate(ctx, [path], ["value", "seq"], map_post,
                                   prefetch_depth=args.prefetch,
                                   unit_batch=1, devices=devs)
        return int(r["hits"])

    pushed()  # warm-up of both bodies outside the timed region
    post()
    snap0 = global_stats.snapshot()
    _drop_cache_hint(path)
    t0 = time.perf_counter()
    h_push = pushed()
    dt_push = time.perf_counter() - t0
    snap1 = global_stats.snapshot()
    _drop_cache_hint(path)
    t0 = time.perf_counter()
    h_post = post()
    dt_post = time.perf_counter() - t0
    d = {k: int(snap1.get(k, 0)) - int(snap0.get(k, 0))
         for k in PUSHDOWN_FIELDS}
    # skipped + submitted = what the unpushed plan would have submitted
    unpushed_bytes = d["parquet_pushdown_skipped_bytes"] \
        + d["parquet_pushdown_submitted_bytes"]
    ok = int(h_push == h_post and d["parquet_pushdown_skipped_bytes"] > 0
             and d["parquet_pushdown_submitted_bytes"] < unpushed_bytes)
    return {
        "pushdown_ok": ok,
        "pushdown_hits": h_push, "unpushed_hits": h_post,
        "pushdown_rows": rows, "pushdown_selectivity": sel,
        "parquet_pushdown_rows_per_s": round(rows / dt_push, 1),
        "parquet_unpushed_rows_per_s": round(rows / dt_post, 1),
        "parquet_pushdown_vs_unpushed": round(dt_post / dt_push, 4),
        "parquet_pushdown_skipped_bytes":
            d["parquet_pushdown_skipped_bytes"],
        "parquet_pushdown_submitted_bytes":
            d["parquet_pushdown_submitted_bytes"],
        "parquet_pushdown_groups_skipped":
            d["parquet_pushdown_groups_skipped"],
        "parquet_pushdown_groups_total": d["parquet_pushdown_groups_total"],
    }


def bench_parquet(args: argparse.Namespace) -> dict:
    """The columnar scan: only the selected columns' chunks are read by the
    engine, the filter and aggregate run on the device (``--cpu-device``:
    on the CPU), row groups LPT-assigned by byte size. Scanned rows/s and
    selected-column GB/s."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.formats.parquet import ParquetShard, write_parquet
    from strom_torch.pipelines.parquet_scan import (parquet_count_where,
                                                    parquet_scan_aggregate)
    from strom_torch.utils.stats import global_stats as _gs

    n_cols = max(int(getattr(args, "columns", 1) or 1), 1)
    compression = str(getattr(args, "compression", "snappy") or "snappy")
    val_dtype = np.dtype(getattr(args, "dtype", "float64") or "float64")
    devs = _parquet_devices(args)
    cfg = StromConfig(engine=args.engine, block_size=args.block,
                      queue_depth=args.depth, num_buffers=max(args.depth * 2, 8),
                      **_obs_config_kw(args))
    path = args.file
    if path is None:
        rows = args.rows
        # named by every generation knob, so a changed flag makes a new one
        key = f"{rows}_{args.row_groups}" + (f"_c{n_cols}" if n_cols > 1 else "") \
            + (f"_{compression}" if compression != "snappy" else "") \
            + (f"_{val_dtype.name}" if val_dtype != np.float64 else "")
        path = os.path.join(args.tmpdir, f"strom_bench_scan_{key}.parquet")
        if not os.path.exists(path):
            rng = np.random.default_rng(0)
            # several columns, so pruning has something to prune; --columns
            # N adds f0..f{N-2} for the wide projection
            cols = {
                "value": rng.standard_normal(rows).astype(val_dtype),
                "key": rng.integers(0, 1 << 30, rows, dtype=np.int64),
                "payload": rng.integers(0, 256, rows, dtype=np.int64),
            }
            for i in range(n_cols - 1):
                cols[f"f{i}"] = rng.standard_normal(rows).astype(val_dtype)
            # --compression none: the native PLAIN writer (no dictionary),
            # so decode is a reinterpretation of the gathered pages
            with StromContext(StromConfig(engine=args.engine)) as wctx:
                write_parquet(wctx, path, cols,
                              row_group_rows=max(rows // args.row_groups, 1),
                              compression="NONE" if compression == "none"
                              else compression)
    raid = args.raid
    members: list[str] = []
    if raid:
        # striped before the context exists, so a failed stripe leaks no
        # engine
        members, logical_bytes = _ensure_striped(path, raid, args.raid_chunk)
    ctx = StromContext(cfg)
    # the process-wide scheduler counters as deltas: other arms of one
    # process share them
    _sched0 = {k: _gs.counter(k).value
               for k in ("coalesce_ops_in", "coalesce_ops_out",
                         "stripe_windows")}
    try:
        if raid:
            virt = path + ".raid0"
            ctx.register_striped(virt, members, args.raid_chunk)
            path = virt
            for m in members:
                _drop_cache_hint(m)
        else:
            _drop_cache_hint(path)
        shard = ParquetShard(path, ctx=ctx)
        meta = shard.metadata
        n_rows = meta.num_rows
        sel_cols = ["value"] + [f"f{i}" for i in range(n_cols - 1)]
        # the schema, not row_group(0): a file with no row groups must
        # reach the scan's own error
        present = set(shard.column_names)
        missing = [c for c in sel_cols if c not in present]
        if missing:
            raise SystemExit(
                f"strom-torch-bench parquet: --columns {n_cols} selects "
                f"{sel_cols} but {path} lacks {missing}; --columns > 1 "
                f"expects the generated fixture schema (omit --file or "
                f"regenerate)")
        sel_bytes = sum(
            meta.row_group(g).column(i).total_compressed_size
            for g in range(meta.num_row_groups)
            for i in range(meta.num_columns)
            if meta.row_group(g).column(i).path_in_schema in sel_cols)

        if n_cols == 1:
            def scan() -> int:
                return parquet_count_where(ctx, [path], "value",
                                           lambda v: v > 0,
                                           prefetch_depth=args.prefetch,
                                           unit_batch=args.unit_batch,
                                           devices=devs)
        else:
            # the wide projection: every selected column feeds the aggregate
            def map_fn(d: dict):
                return {"hits": (d["value"] > 0).sum(),
                        "fsum": sum(d[c].sum() for c in sel_cols[1:])}

            def scan() -> int:
                res = parquet_scan_aggregate(ctx, [path], sel_cols, map_fn,
                                             prefetch_depth=args.prefetch,
                                             unit_batch=args.unit_batch,
                                             devices=devs)
                return int(res["hits"])
        scan()  # warm-up outside the timed region
        disk_rate = bool(getattr(args, "disk_rate", False))
        drop_paths = members if raid else [path]
        scan_dts: list[float] = []
        raw_gbps_list: list[float] = []
        hits = 0
        plain_bytes = pyarrow_bytes = 0

        def scan_arm() -> None:
            nonlocal hits, plain_bytes, pyarrow_bytes
            snap0 = _gs.snapshot()
            t0 = time.perf_counter()
            hits = scan()
            scan_dts.append(time.perf_counter() - t0)
            snap1 = _gs.snapshot()
            # which decode route the timed bytes took
            plain_bytes += snap1.get("parquet_plain_bytes", 0) \
                - snap0.get("parquet_plain_bytes", 0)
            pyarrow_bytes += snap1.get("parquet_decode_bytes", 0) \
                - snap0.get("parquet_decode_bytes", 0)

        if disk_rate:
            # --disk-rate: a bare engine gather of exactly the selected
            # chunks' extents (with --raid expanded to member ops here), the
            # arms alternating over 2 passes, best of each: selected_gbps /
            # disk_read_gbps is the scan's cost over the raw reads
            from strom_torch.delivery.buffers import alloc_aligned
            from strom_torch.engine import make_engine
            from strom_torch.engine.raid0 import plan_stripe_reads

            raw_extents = [e for g in range(meta.num_row_groups)
                           for e in shard.column_chunk_extents(
                               g, sel_cols).extents]
            raw_total = sum(e.length for e in raw_extents)
            raw_dest = alloc_aligned(raw_total)

            def raw_arm() -> None:
                eng = make_engine(cfg)
                try:
                    ops = []
                    off = 0
                    if raid:
                        member_fi = [eng.register_file(m, o_direct=True)
                                     for m in members]
                        for e in raw_extents:
                            for s in plan_stripe_reads(
                                    e.offset, e.length, raid,
                                    args.raid_chunk):
                                ops.append((member_fi[s.member],
                                            s.member_offset,
                                            off + (s.logical_offset
                                                   - e.offset),
                                            s.length))
                            off += e.length
                    else:
                        fi = eng.register_file(path, o_direct=True)
                        for e in raw_extents:
                            ops.append((fi, e.offset, off, e.length))
                            off += e.length
                    eng.register_dest(raw_dest)
                    t0 = time.perf_counter()
                    n_read = eng.read_vectored(ops, raw_dest)
                    d = time.perf_counter() - t0
                finally:
                    eng.close()
                assert n_read == raw_total
                raw_gbps_list.append(raw_total / d / 1e9)

            for i in range(2):
                for arm in ((scan_arm, raw_arm) if i % 2 == 0
                            else (raw_arm, scan_arm)):
                    for p in drop_paths:
                        _drop_cache_hint(p)
                    arm()
        else:
            for p in drop_paths:
                _drop_cache_hint(p)
            scan_arm()
        dt = min(scan_dts)
        plain_bytes //= len(scan_dts)
        pyarrow_bytes //= len(scan_dts)
        disk_gbps = round(max(raw_gbps_list), 4) if raw_gbps_list else None
        pd_res = _pushdown_ab(ctx, args) \
            if getattr(args, "pushdown", False) else {}
        sched = {k: _gs.counter(k).value - v0 for k, v0 in _sched0.items()}
    finally:
        ctx.close()
    return {
        **pd_res,
        "bench": "parquet_scan",
        "rows_per_s": round(n_rows / dt, 1),
        "selected_gbps": round(sel_bytes / dt / 1e9, 4),
        "rows": n_rows, "row_groups": meta.num_row_groups,
        "selected_bytes": sel_bytes, "hits": int(hits),
        "selected_columns": len(sel_cols),
        # logical bytes either way, so striped and plain runs agree
        "total_bytes": logical_bytes if raid else os.path.getsize(path),
        "engine": cfg.engine,
        "unit_batch": args.unit_batch, "raid_members": raid,
        "compression": compression,
        "disk_read_gbps": disk_gbps,
        "vs_disk": round(sel_bytes / dt / 1e9 / disk_gbps, 4)
        if disk_gbps else None,
        "selected_gbps_passes": [round(sel_bytes / d / 1e9, 4)
                                 for d in scan_dts],
        "disk_gbps_passes": [round(g, 4) for g in raw_gbps_list],
        "plain_decoded_bytes": int(plain_bytes),
        "pyarrow_decoded_bytes": int(pyarrow_bytes),
        "coalesce_ops_in": sched["coalesce_ops_in"],
        "coalesce_ops_out": sched["coalesce_ops_out"],
        "stripe_windows": sched["stripe_windows"],
    }


def _scoped_sched_delta(tenant: str, snap0: dict) -> dict:
    """A tenant's scheduler and engine columns since *snap0* (a snapshot of
    ``global_stats.scoped(tenant=...)``): the SCHED_FIELDS counters, the
    queue-wait and per-op latency percentiles of the bucket deltas."""
    from strom_torch.utils.stats import global_stats, percentile_from_buckets

    snap1 = global_stats.scoped(tenant=tenant).snapshot()
    out = {k: int(snap1.get(k, 0) - snap0.get(k, 0))
           for k in ("sched_granted_ops", "sched_granted_bytes",
                     "sched_throttle_waits")}

    def delta_buckets(stem: str) -> list:
        b0 = snap0.get(stem + "_hist") or []
        b1 = snap1.get(stem + "_hist") or []
        return [a - b for a, b in zip(b1, b0)] if b0 else list(b1)

    qw = delta_buckets("sched_queue_wait")
    out["sched_queue_wait_p50_us"] = percentile_from_buckets(qw, 0.50)
    out["sched_queue_wait_p99_us"] = percentile_from_buckets(qw, 0.99)
    out["engine_op_lat_p99_us"] = percentile_from_buckets(
        delta_buckets("engine_op_lat"), 0.99)
    return out


def bench_multitenant(args: argparse.Namespace, workloads=None) -> dict:
    """Concurrent tenants on ONE StromContext through the scheduler: each
    tenant alone first (its baseline), then all at once on threads. Per
    tenant (``mt_<tenant>_``): items/s, ``vs_solo``, queue-wait p50/p99,
    granted bytes, the engine's per-op latency p99 (SCHED_FIELDS); and
    ``mt_vs_solo_mean``, the mean of the concurrent/solo ratios.

    The reference's tenants: two training-class JPEG vision loaders and one
    interactive Parquet scan, whose p99 queue wait shows it is not starved.
    *workloads* (``ctx -> [(tenant, priority, fn)]``, ``fn(tenant)`` →
    items/s) replaces them with the caller's (``chip_smoke.py``'s
    full-width tenants); with the scheduler off (``STROM_SCHED_ENABLED=0``)
    no tenant is registered and the scheduler columns read 0."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.sched.scheduler import SCHED_FIELDS  # noqa: F401 (contract)
    from strom_torch.utils.stats import global_stats as _gs

    steps = int(getattr(args, "steps", 6) or 6)
    batch = int(getattr(args, "batch", 8) or 8)
    image_size = int(getattr(args, "image_size", 64) or 64)
    pq_iters = int(getattr(args, "pq_iters", 2) or 2)
    rows = int(getattr(args, "rows", 200_000) or 200_000)
    cfg = StromConfig.from_env(engine=args.engine, block_size=args.block,
                               queue_depth=args.depth,
                               num_buffers=max(args.depth * 2, 8),
                               **_obs_config_kw(args))
    if workloads is None:
        workloads = _reference_tenants(args, cfg, steps, batch, image_size,
                                       pq_iters, rows)
    ctx = StromContext(cfg)
    out: dict = {"bench": "multitenant", "steps": steps, "batch": batch,
                 "image_size": image_size, "engine": cfg.engine,
                 "sched_enabled": cfg.sched_enabled}
    try:
        tenants = workloads(ctx)
        if ctx.scheduler is not None:
            for name, prio, _ in tenants:
                ctx.register_tenant(name, priority=prio)
        solo = {name: fn(name) for name, _, fn in tenants}

        # all tenants at once; per-tenant deltas from the tenant scopes
        snaps = {name: dict(_gs.scoped(tenant=name).snapshot())
                 for name, _, _ in tenants}
        conc: dict[str, float] = {}
        errs: list = []

        def run(name, fn):
            try:
                conc[name] = fn(name)
            except BaseException as e:  # surfaced after the join
                errs.append((name, e))

        threads = [threading.Thread(target=run, args=(name, fn), daemon=True,
                                    name=f"strom-mt-{name}")
                   for name, _, fn in tenants]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["concurrent_wall_s"] = round(time.perf_counter() - t0, 2)
        if errs:
            raise errs[0][1]

        ratios = []
        for name, _, _ in tenants:
            d = _scoped_sched_delta(name, snaps[name])
            vs = round(conc[name] / solo[name], 3) if solo[name] else None
            d["items_per_s"] = round(conc[name], 1)
            d["vs_solo"] = vs
            if vs is not None:
                ratios.append(vs)
            for k, v in d.items():
                out[f"mt_{name}_{k}"] = v
            out[f"mt_{name}_solo_items_per_s"] = round(solo[name], 1)
        # the MEAN of per-tenant ratios (their units differ)
        out["mt_vs_solo_mean"] = round(sum(ratios) / len(ratios), 3) \
            if ratios else None
        out["mt_tenants"] = [name for name, _, _ in tenants]
    finally:
        ctx.close()
    return out


def _reference_tenants(args, cfg, steps: int, batch: int, image_size: int,
                       pq_iters: int, rows: int):
    """The reference arm's tenants as a *workloads* callable: ``vis0`` and
    ``vis1`` (training: the JPEG vision loader, ``steps`` timed batches
    after a warm-up) and ``pq`` (interactive: ``pq_iters`` count-where
    scans on the CPU)."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.formats.parquet import write_parquet
    from strom_torch.pipelines import make_wds_vision_pipeline
    from strom_torch.pipelines.parquet_scan import parquet_count_where

    tar = args.file or _made_once(lambda: _mk_wds_fixture(
        args.tmpdir, batch, image_size))
    pq_path = os.path.join(args.tmpdir, f"strom_bench_mt_{rows}.parquet")

    def make_pq() -> None:
        if not os.path.exists(pq_path):
            rng = np.random.default_rng(0)
            with StromContext(StromConfig(engine=cfg.engine)) as wctx:
                write_parquet(wctx, pq_path, {
                    "value": rng.standard_normal(rows),
                    "key": rng.integers(0, 1 << 30, rows, dtype=np.int64)},
                    row_group_rows=max(rows // 8, 1), compression="snappy")

    _rank0_first(make_pq)
    dev = _device(args)

    def make(ctx):
        # the vision tenants' rows over every process, one mesh for both
        _, where = _vision_where(batch, dev)

        def vision_run(tenant: str) -> float:
            pipe = make_wds_vision_pipeline(
                ctx, [tar], batch=batch, image_size=image_size,
                decode_workers=2,
                scope={"pipeline": "resnet", "tenant": tenant}, **where)
            try:
                next(pipe)  # warm-up
                t0 = time.perf_counter()
                imgs = None
                for _ in range(steps):
                    imgs, _ = next(pipe)
                if imgs is not None:
                    _fetch_one(imgs)
                dt = time.perf_counter() - t0
            finally:
                pipe.close()
            return steps * batch / dt if dt else 0.0

        def pq_run(tenant: str) -> float:
            t0 = time.perf_counter()
            for _ in range(pq_iters):
                parquet_count_where(ctx, [pq_path], "value",
                                    lambda v: v > 0, devices=["cpu"],
                                    scope={"pipeline": "parquet",
                                           "tenant": tenant})
            dt = time.perf_counter() - t0
            return pq_iters * rows / dt if dt else 0.0

        return [("vis0", "training", vision_run),
                ("vis1", "training", vision_run),
                ("pq", "interactive", pq_run)]

    return make


def cmd_daemon(args: argparse.Namespace) -> dict:
    """A long-lived delivery daemon: one StromContext and its scheduler
    serving tenants over the live HTTP surface (GET /tenants shows queue
    depth and budgets, POST /tenants registers or drains). SIGTERM or
    SIGINT drains every registered tenant (no queued request, no active
    grant) before the flight recorder's handler chain runs, saves the
    tuner's profile, and the process ends by the signal."""
    import signal as _signal

    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext

    cfg = StromConfig.from_env(engine=args.engine,
                               flight_dir=getattr(args, "flight_dir", "")
                               or "",
                               flight_stall_s=float(
                                   getattr(args, "flight_stall_s", 30.0)
                                   or 0.0),
                               tune=bool(getattr(args, "tune", False)),
                               tune_profile=getattr(args, "profile", "")
                               or "",
                               **_cache_config_kw(args))
    # the daemon always serves (0 = an ephemeral port): without /tenants
    # it could not be reached
    ctx = StromContext(cfg, metrics_port=int(args.metrics_port or 0))
    srv = ctx.metrics_server
    stop = threading.Event()
    got: dict = {"sig": None}
    # installed after the context and its flight recorder: this handler
    # runs first, the recorder's stays chained behind it
    prev = {s: _signal.getsignal(s)
            for s in (_signal.SIGTERM, _signal.SIGINT)}

    def on_sig(signum, frame):
        got["sig"] = signum
        stop.set()

    for s in prev:
        _signal.signal(s, on_sig)
    print(f"strom daemon ready port={srv.port if srv else 0} "
          f"pid={os.getpid()}", flush=True)
    stop.wait()
    stuck: list = []
    n_tenants = 0
    if ctx.scheduler is not None:
        stuck = ctx.scheduler.drain_all(
            timeout_s=float(getattr(args, "drain_timeout", 10.0)))
        n_tenants = len(ctx.scheduler.tenants_info()["tenants"])
    print(f"strom daemon drained tenants={n_tenants} stuck={stuck}",
          flush=True)
    # the converged knobs saved before the re-raise below ends the process
    profile_path = getattr(args, "profile", "") or ""
    if ctx.tuner is not None and profile_path:
        try:
            ctx.tuner.settle()  # never persist an unevaluated trial
            ctx.tuner.profile().save(profile_path)
        except OSError as e:
            print(f"tune profile save failed: {e}", file=sys.stderr)
    sig = got["sig"]
    for s, h in prev.items():
        _signal.signal(s, h)
    if sig == _signal.SIGTERM:
        # delivered again, so the chained handlers run in order (the
        # recorder dumps against the live context, then restores the
        # default) and the exit status still says killed by SIGTERM
        _signal.raise_signal(_signal.SIGTERM)
    elif sig == _signal.SIGINT:
        # the default action, so the status says killed by SIGINT (the
        # restored Python handler would raise KeyboardInterrupt)
        _signal.signal(_signal.SIGINT, _signal.SIG_DFL)
        _signal.raise_signal(_signal.SIGINT)
    ctx.close()
    return {"bench": "daemon", "port": srv.port if srv else 0,
            "tenants": n_tenants, "stuck": stuck, "signal": sig}


def bench_tune(args: argparse.Namespace) -> dict:
    """The autotuner arm: one shuffled block-read workload on the hand
    knobs, then after the coordinate-descent tuner searched the live
    knobs (the scheduler's slice, the cache budget) against measured
    items/s, then an interleaved A/B of the two: a searched state that
    loses it ships the hand knobs, so ``tuned_vs_hand`` is at least 1.
    ``searched_vs_hand`` is the searched state's own rate in that A/B over
    the hand knobs', which a harmful search drives below 1. ``--profile``
    warm-starts from a saved profile and saves the result. Keys:
    TUNE_BENCH_FIELDS."""
    import random

    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.tune import TUNE_BENCH_FIELDS  # noqa: F401 (contract)
    from strom_torch.tune import Autotuner, Profile, standard_knobs

    path = args.file
    created = False
    if path is None:
        path = os.path.join(args.tmpdir, "strom_bench_tune.bin")
        if not os.path.exists(path) or os.path.getsize(path) < args.size:
            _mk_testfile(path, args.size)
        created = True
    size = min(os.path.getsize(path), args.size) // args.block * args.block
    cfg = StromConfig.from_env(engine=args.engine, block_size=args.block,
                               queue_depth=args.depth,
                               num_buffers=max(args.depth * 2, 8),
                               hot_cache_bytes=args.cache_bytes,
                               hot_cache_admit="always",
                               **_obs_config_kw(args))
    ctx = StromContext(cfg, metrics_port=args.metrics_port or None)
    try:
        offs = list(range(0, size, args.block))
        rng = random.Random(0)

        def epoch() -> float:
            order = offs[:]
            rng.shuffle(order)
            t0 = time.perf_counter()
            for off in order:
                ctx.pread(path, off, min(args.block, size - off))
            return len(order) / (time.perf_counter() - t0)

        epoch()  # the cache warmed once: both phases measure steady state
        hand = max(epoch() for _ in range(args.iters))
        last = {"rate": hand}
        knobs = standard_knobs(ctx)
        hand_knobs = {k.name: float(k.get()) for k in knobs}
        tuner = Autotuner(knobs,
                          lambda: {"objective": last["rate"]},
                          guard_frac=cfg.tune_guard_frac,
                          scope=ctx.scope,
                          profile_name=os.path.splitext(os.path.basename(
                              args.profile))[0] if args.profile else "tune")
        if args.profile and os.path.exists(args.profile):
            tuner.apply_profile(Profile.load(args.profile))
        # one measured epoch a beat (the propose/evaluate machine settles
        # on real rates)
        for _ in range(args.trials):
            tuner.step()
            last["rate"] = epoch()
        # judge the last trial without proposing another
        tuner.settle()
        tuned_knobs = {k.name: float(k.get()) for k in knobs}

        def apply(vals: dict) -> None:
            for k in knobs:
                k.set(k.clamp(vals[k.name]))

        if tuned_knobs == hand_knobs:
            # every trial reverted: the tuned state is the hand state
            searched = tuned = hand = max(hand, epoch())
        else:
            # interleaved, so the drift cancels out of the ratio
            searched = hand = 0.0
            for _ in range(args.iters):
                apply(tuned_knobs)
                searched = max(searched, epoch())
                apply(hand_knobs)
                hand = max(hand, epoch())
            tuned = searched
            if searched >= hand:
                apply(tuned_knobs)  # ship the validated win
            else:
                # a search win that loses the A/B was noise: ship hand
                tuned_knobs = hand_knobs
                tuned = hand
        ts = tuner.stats()
        es = ctx.engine.stats()
        if args.profile:
            tuner.profile().save(args.profile)
        out = {
            "bench": "tune", "bytes": size, "block": args.block,
            "engine": cfg.engine, "trials": args.trials,
            "hand_items_per_s": round(hand, 2),
            "tuned_items_per_s": round(tuned, 2),
            "tuned_vs_hand": round(tuned / hand, 4) if hand else 0.0,
            "searched_items_per_s": round(searched, 2),
            "searched_vs_hand": round(searched / hand, 4) if hand else 0.0,
            "tune_moves": ts["tune_moves"],
            "tune_reverts": ts["tune_reverts"],
            "tune_holds": ts["tune_holds"],
            "tune_knobs": ts["tune_knobs"],
            "tune_profile": args.profile or "",
            "engine_fixed_buf_ratio":
                round(float(es.get("engine_fixed_buf_ratio", 0.0)), 4),
            "engine_unregistered_reads":
                int(es.get("engine_unregistered_reads", 0)),
            "file_created": created,
        }
        out.update(_sqpoll_ab(cfg, path, size, args))
        if not args.json:
            print(f"  hand {hand:.1f} it/s -> tuned {tuned:.1f} it/s "
                  f"(x{out['tuned_vs_hand']}) after {args.trials} trials: "
                  f"{ts['tune_moves']} moves, {ts['tune_reverts']} reverts; "
                  f"knobs {ts['tune_knobs']}", file=sys.stderr)
        return out
    finally:
        ctx.close()


def bench_chaos(args: argparse.Namespace, make_pipe=None,
                on_pass=None) -> dict:
    """The resnet JPEG loader twice over one fixture: clean, then under a
    seeded fault plan (EIO, short reads, latency spikes on the engine's op
    stream), both under the lock-order witness with the residency hybrid
    off (the plan sees the media op stream). Every batch is hashed:
    ``chaos_ok=1`` means the faulted run finished with the clean run's
    batches; ``chaos_slowdown`` is the price; the resilience deltas say
    what absorbed the faults. Keys: CHAOS_BENCH_FIELDS.

    *make_pipe* (``ctx -> pipeline``) replaces the loader (``chip_smoke``'s
    full-width arms); *on_pass* (``(fault_plan, ctx)``) runs at the end of
    each pass, before its context closes. The config honours ``STROM_*``."""
    import hashlib

    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.engine.resilience import CHAOS_BENCH_FIELDS  # noqa: F401 (contract)
    from strom_torch.pipelines import make_imagenet_resnet_pipeline
    from strom_torch.utils.stats import global_stats as _gs

    path = args.file
    if path is None:
        path = _mk_wds_fixture(args.tmpdir, args.batch, args.image_size)
    plan_spec = getattr(args, "fault_plan", "") or \
        f"chaos:{int(getattr(args, 'seed', 0))}"
    if make_pipe is None:
        dev = _device(args)

        def make_pipe(ctx):
            return make_imagenet_resnet_pipeline(
                ctx, [path], batch=args.batch, image_size=args.image_size,
                device=dev, prefetch_depth=args.prefetch,
                decode_workers=args.decode_workers)

    def one_pass(fault_plan: str) -> tuple[float, list[str], int]:
        cfg = StromConfig.from_env(engine=args.engine, block_size=args.block,
                                   queue_depth=args.depth,
                                   num_buffers=max(args.depth * 2, 8),
                                   residency_hybrid=False,
                                   fault_plan=fault_plan,
                                   # the witness checks the lock order on
                                   # the retry, failover and hedge paths
                                   # the clean arms never enter
                                   debug_locks=True)
        _drop_cache_hint(path)
        ctx = StromContext(cfg)
        try:
            with make_pipe(ctx) as pipe:
                hashes = []
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    imgs, lbls = next(pipe)
                    h = hashlib.sha256()
                    h.update(imgs.cpu().numpy().tobytes())
                    h.update(lbls.cpu().numpy().tobytes())
                    hashes.append(h.hexdigest())
                dt = time.perf_counter() - t0
            injected = 0
            plan = getattr(ctx.engine, "plan", None)
            if plan is not None:
                injected = plan.stats()["faults_injected"]
            if on_pass is not None:
                on_pass(fault_plan, ctx)
            return (args.steps * args.batch / dt if dt else 0.0, hashes,
                    injected)
        finally:
            ctx.close()

    clean_rate, clean_hashes, _ = one_pass("")
    snap0 = _gs.snapshot()
    faulty_rate, faulty_hashes, injected = one_pass(plan_spec)
    resil = _resil_delta(snap0)
    out = {
        "bench": "chaos",
        "batch": args.batch, "image_size": args.image_size,
        "steps": args.steps, "engine": args.engine,
        "fault_plan": plan_spec,
        "chaos_ok": int(bool(clean_hashes)
                        and clean_hashes == faulty_hashes),
        "chaos_slowdown": round(clean_rate / faulty_rate, 3)
        if faulty_rate else None,
        "chaos_clean_images_per_s": round(clean_rate, 1),
        "chaos_faulty_images_per_s": round(faulty_rate, 1),
        "chaos_faults_injected": injected,
        "chaos_chunk_retries": resil["chunk_retries"],
        "chaos_failover_reads": resil["failover_reads"],
        "chaos_breaker_trips": resil["breaker_trips"],
        "chaos_hedges_fired": resil["hedges_fired"],
    }
    out.update({k: v for k, v in resil.items() if k not in out})
    return out


def _leaves_equal(a, b) -> bool:
    """Every leaf of two state trees equal, bit for bit."""
    import torch

    from strom_torch.ckpt.checkpoint import tree_flatten

    la, _ = tree_flatten(a)
    lb, _ = tree_flatten(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x.cpu(), y.cpu())):
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            return False
    return True


def _llama_state_tree(args: argparse.Namespace):
    """A fresh Llama train state of --model (seed 0) on the arm's device,
    as the tree a checkpoint saves."""
    from strom_torch.models.llama import LlamaConfig
    from strom_torch.parallel.train import (init_train_state, make_optimizer,
                                            train_state_tree)

    mcfg = getattr(LlamaConfig, args.model)()
    state = init_train_state(mcfg, make_optimizer(), device=_device(args),
                             seed=0)
    return train_state_tree(state)


def bench_checkpoint(args: argparse.Namespace) -> dict:
    """The write path: an engine checkpoint of the Llama train state saved
    and restored, against pickle to the filesystem, then a spill epoch pair
    over an engine-written token fixture.

    1. ckpt: ``save_checkpoint`` (chunked ``op="write"`` gathers through
       pinned staging, tmp+rename commit) in MB/s beside ``save_pickle``;
       the restore rides ``memcpy_ssd2gpu`` and must equal the state bit
       for bit (``ckpt_roundtrip_ok``). Keys: CKPT_FIELDS.
    2. spill: a small hot cache over the fixture: epoch 1 admits and
       evicts into the spill tier, epoch 2 reads the same records from RAM
       and spill with no source read (``spill_cache_miss_bytes`` 0). Keys:
       SPILL_FIELDS."""
    import torch

    from strom_torch.ckpt import (CKPT_FIELDS, restore_checkpoint,  # noqa: F401
                                  save_checkpoint, save_pickle)
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.delivery.spill import SPILL_FIELDS  # noqa: F401 (contract)
    from strom_torch.formats.rawbin import TokenShardSet, write_token_shard

    cfg = StromConfig(engine=args.engine, block_size=args.block,
                      queue_depth=args.depth,
                      num_buffers=max(args.depth * 2, 8),
                      **_obs_config_kw(args))
    out: dict = {"bench": "checkpoint", "engine": cfg.engine,
                 "model": args.model}
    ctx = StromContext(cfg)
    try:
        state = _llama_state_tree(args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        d = os.path.join(args.tmpdir, "strom_bench_ckpt")
        t0 = time.perf_counter()
        manifest = save_checkpoint(ctx, d, state)
        save_s = time.perf_counter() - t0
        payload = manifest["payload_bytes"]
        pk = os.path.join(args.tmpdir, "strom_bench_ckpt.pkl")
        t0 = time.perf_counter()
        save_pickle(pk, state)
        pickle_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = restore_checkpoint(ctx, d, state)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ok = _leaves_equal(state, back)
        del back
        mb = payload / 1e6
        out.update({
            "ckpt_bytes": payload,
            "ckpt_leaves": len(manifest["leaves"]),
            "ckpt_save_mb_per_s": round(mb / save_s, 1) if save_s else None,
            "ckpt_restore_mb_per_s":
                round(mb / restore_s, 1) if restore_s else None,
            "ckpt_pickle_save_mb_per_s":
                round(mb / pickle_s, 1) if pickle_s else None,
            "ckpt_save_vs_pickle":
                round(pickle_s / save_s, 3) if save_s else None,
            "ckpt_roundtrip_ok": int(ok),
        })
        with contextlib.suppress(OSError):
            os.unlink(pk)
        shutil.rmtree(d, ignore_errors=True)
    finally:
        ctx.close()

    # -- spill epoch pair ---------------------------------------------------
    fixture_bytes = 16 << 20
    record_tokens = 1024
    scfg = StromConfig(engine=args.engine, block_size=args.block,
                       queue_depth=args.depth,
                       num_buffers=max(args.depth * 2, 8),
                       hot_cache_bytes=max(fixture_bytes // 8, 1 << 20),
                       hot_cache_admit="always",
                       spill_bytes=fixture_bytes * 2,
                       spill_dir=args.tmpdir,
                       **_obs_config_kw(args))
    sctx = StromContext(scfg)
    try:
        shard = os.path.join(args.tmpdir, "strom_bench_spill_tokens.bin")
        rng = np.random.default_rng(7)
        toks = rng.integers(0, 1 << 15,
                            fixture_bytes // 4, dtype=np.int32)
        # the fixture written by the engine that reads it back
        write_token_shard(sctx, shard, toks)
        ss = TokenShardSet((shard,), record_tokens=record_tokens)
        _drop_cache_hint(shard)
        step = 32  # records a read

        def one_epoch() -> float:
            t0 = time.perf_counter()
            for lo in range(0, ss.num_records - step + 1, step):
                sctx.pread(ss.extents(list(range(lo, lo + step))))
            return time.perf_counter() - t0

        one_epoch()  # epoch 1: cold — admit, evict, demote to spill
        s1 = sctx.stats(sections=["cache", "spill"])
        miss1 = s1["cache"]["cache_miss_bytes"]
        cold_spilled = s1["spill"]["spill_spilled_bytes"]
        warm_s = one_epoch()  # epoch 2: RAM + spill, no source read
        s2 = sctx.stats(sections=["cache", "spill"])
        sp = s2["spill"]
        out.update({
            "spill_hit_bytes": sp["spill_hit_bytes"],
            "spill_hits": sp["spill_hits"],
            "spill_spilled_bytes": cold_spilled,
            "spill_entries": sp["spill_entries"],
            "spill_bytes": sp["spill_bytes"],
            "spill_hit_ratio": sp["spill_hit_ratio"],
            "spill_promote_bytes": sp["spill_promote_bytes"],
            "spill_engine_ops": sp["spill_engine_ops"],
            "spill_fallback_ops": sp["spill_fallback_ops"],
            # repeat traffic never misses to the source engine
            "spill_cache_miss_bytes":
                s2["cache"]["cache_miss_bytes"] - miss1,
            "spill_warm_mb_per_s":
                round(fixture_bytes / 1e6 / warm_s, 1) if warm_s else None,
        })
        with contextlib.suppress(OSError):
            os.unlink(shard)
    finally:
        sctx.close()
    return out


def bench_resume(args: argparse.Namespace) -> dict:
    """Preemption safety: the async save's stall against the blocking
    save's wall, then a kill and restart.

    1. The Llama train state saved once blocking, then --saves times
       through the AsyncCheckpointer with the writer drained between saves
       (each stall is the pure snapshot and hand-off);
       ``ckpt_async_stall_frac`` is the mean stall over the blocking wall;
       the last commit is restored CRC-verified and must equal the state.
       Keys: CKPT_ASYNC_FIELDS.
    2. ``faults.resume_harness.run_kill_resume``: a subprocess trainer
       killed at a seeded step inside the first epoch, restarted from the
       last commit and its StepToken; the rest of the batch stream must
       equal an uninterrupted run's. Keys: RESUME_FIELDS."""
    import torch

    from strom_torch.ckpt import (AsyncCheckpointer, restore_checkpoint,
                                  save_checkpoint)
    from strom_torch.ckpt.async_save import CKPT_ASYNC_FIELDS  # noqa: F401 (contract)
    from strom_torch.ckpt.jobstate import RESUME_FIELDS
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.faults.resume_harness import run_kill_resume

    cfg = StromConfig(engine=args.engine, block_size=args.block,
                      queue_depth=args.depth,
                      num_buffers=max(args.depth * 2, 8),
                      **_obs_config_kw(args))
    out: dict = {"bench": "resume", "engine": cfg.engine,
                 "model": args.model}
    ctx = StromContext(cfg)
    try:
        state = _llama_state_tree(args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        d = os.path.join(args.tmpdir, "strom_bench_resume_ckpt")
        t0 = time.perf_counter()
        manifest = save_checkpoint(ctx, d, state)
        sync_wall_us = (time.perf_counter() - t0) * 1e6
        payload = manifest["payload_bytes"]
        cp = AsyncCheckpointer(ctx, d)
        commit_walls = []
        try:
            for _ in range(max(args.saves, 1)):
                t0 = time.perf_counter()
                cp.save(state)
                cp.wait()  # drained between saves: the stall is the snapshot
                commit_walls.append(time.perf_counter() - t0)
        finally:
            cp.close()
        back = restore_checkpoint(ctx, d, state, verify=True)
        ok = _leaves_equal(state, back)
        del back
        st = cp.stats()
        stall_mean = st["ckpt_async_stall_mean_us"]
        commit_s = min(commit_walls) if commit_walls else 0.0
        out.update({
            "ckpt_bytes": payload,
            "ckpt_async_saves": st["ckpt_async_saves"],
            "ckpt_async_stall_p99_us": st["ckpt_async_stall_p99_us"],
            "ckpt_async_stall_mean_us": stall_mean,
            "ckpt_sync_save_wall_us": round(sync_wall_us, 1),
            "ckpt_async_stall_frac":
                round(stall_mean / sync_wall_us, 4) if sync_wall_us else None,
            "ckpt_async_commit_mb_per_s":
                round(payload / 1e6 / commit_s, 1) if commit_s else None,
            "ckpt_async_roundtrip_ok": int(ok),
        })
        shutil.rmtree(d, ignore_errors=True)
    finally:
        ctx.close()

    # -- kill/restart cycle -------------------------------------------------
    wd = os.path.join(args.tmpdir, "strom_bench_resume_harness")
    shutil.rmtree(wd, ignore_errors=True)
    res = run_kill_resume(wd, seed=args.seed, sig=args.signal,
                          engine=args.engine if args.engine != "auto"
                          else "python")
    for k in RESUME_FIELDS:
        out[k] = res.get(k)
    if res.get("failures"):
        out["resume_failures"] = res["failures"][:4]
    shutil.rmtree(wd, ignore_errors=True)
    return out


def bench_dist(args: argparse.Namespace) -> dict:
    """The distributed data plane: an N-process ingest over a token fixture
    written through the engine. Each worker owns the files the
    consistent-hash ring gives it, warms them into its hot cache, serves
    them to its peers over the extent service (strom_torch/dist/peers.py)
    and assembles its slice of every global batch through the delivery
    plan: rows of another host's files arrive over the socket, not as a
    second SSD read. ``--mode mesh`` puts each slice on the worker's card
    (one process a card).

    ``dist_ok=1``: every worker exited 0 and every worker's rows were
    bit-identical to the single-process reference's;
    ``dist_peer_hit_ratio`` is the share of batch bytes served by peers;
    ``dist_engine_ingest_bytes`` must be 0 (no second SSD read). A
    single-process pass rates the same rows for ``dist_vs_single``.
    ``--batch-ab`` reruns the fleet unbatched, ``--peer-compress`` with the
    compressed wire. Keys: ``strom_torch.dist.peers.DIST_BENCH_FIELDS``."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.dist.launch import measure_ingest
    from strom_torch.dist.peers import DIST_BENCH_FIELDS  # noqa: F401 (contract)
    from strom_torch.formats.rawbin import write_token_shard

    wd = os.path.join(args.tmpdir, "strom_bench_dist")
    shutil.rmtree(wd, ignore_errors=True)
    data_dir = os.path.join(wd, "data")
    os.makedirs(data_dir, exist_ok=True)
    # the fixture through the engine's write path: written by the
    # machinery that later reads it
    rng = np.random.default_rng(args.seed)
    ctx = StromContext(StromConfig(engine=args.engine, queue_depth=8,
                                   num_buffers=16))
    try:
        for i in range(args.files):
            write_token_shard(
                ctx, os.path.join(data_dir, f"shard{i}.bin"),
                rng.integers(0, 32000, (args.records, args.seq_len),
                             dtype=np.int32))
    finally:
        ctx.close()

    worker_engine = args.engine if args.engine != "auto" else "python"
    kw = dict(data_dir=data_dir, steps=args.steps, batch=args.batch,
              seq_len=args.seq_len, seed=args.seed, engine=worker_engine,
              mode=args.mode, devices_per_proc=args.devices_per_proc)
    single = measure_ingest(1, os.path.join(wd, "single"), **kw)
    # the fault plan rides the workers (peer-op rules fire on their
    # fetches); the single process has no peers to fail
    multi = measure_ingest(args.procs, os.path.join(wd, "multi"),
                           fault_plan=args.fault_plan or "", **kw)
    workers = multi.pop("workers")
    single_rate = single.get("dist_items_per_s") or 0.0
    out = {
        "bench": "dist",
        "procs": args.procs, "mode": args.mode, "engine": worker_engine,
        "batch": args.batch, "seq_len": args.seq_len, "files": args.files,
        **multi,
        "dist_single_items_per_s": single_rate,
        "dist_vs_single":
            round(multi["dist_items_per_s"] / single_rate, 3)
            if single_rate else None,
        # the single pass must be clean itself, or vs_single is noise
        "dist_single_ok": single.get("dist_ok"),
        "dist_worker_errors": sum(w.get("peer_errors", 0) for w in workers),
    }
    if args.batch_ab:
        # the same fleet, seed and steps with the batched wire off: every
        # peer miss pays its own round trip; both passes bit-identical
        unb = measure_ingest(args.procs, os.path.join(wd, "multi_unbatched"),
                             batch_extents=0, **kw)
        unb.pop("workers", None)
        unb_rate = unb.get("dist_items_per_s") or 0.0
        out.update({
            "dist_unbatched_ok": unb.get("dist_ok"),
            "dist_unbatched_items_per_s": unb_rate,
            "dist_batch_vs_single":
                round(multi["dist_items_per_s"] / unb_rate, 3)
                if unb_rate else None,
        })
    if args.peer_compress:
        # the same fleet with the compressed wire: the same rows, and the
        # wire bytes for the same served payloads (the raw pass's wire
        # bytes are its served bytes)
        comp = measure_ingest(args.procs, os.path.join(wd, "multi_comp"),
                              peer_compress=True, **kw)
        comp.pop("workers", None)
        raw_wire = multi["dist_peer_wire_bytes"]
        comp_wire = comp.get("dist_peer_wire_bytes", 0)
        out.update({
            "dist_comp_ok": comp.get("dist_ok"),
            "dist_peer_raw_wire_bytes": raw_wire,
            "dist_peer_comp_wire_bytes": comp_wire,
            # > 1: the compressed pass moved fewer bytes for the same rows
            "dist_peer_comp_vs_raw":
                round(raw_wire / comp_wire, 4) if comp_wire else None,
            "peer_comp_ratio": comp.get("peer_comp_ratio", 0.0),
        })
    shutil.rmtree(wd, ignore_errors=True)
    return out


def bench_all(args: argparse.Namespace) -> dict:
    """Every configuration in one run at quick shapes: the raw read, the
    host ratio plain and striped, delivery to the device, the llama,
    resnet and vit loaders with their captured train steps, and the
    Parquet scan plain, striped, wide and PLAIN. A failed phase never
    stops the rest; it is named in ``failed``."""
    size = args.size
    # --file applies to the byte phases (llama reads it as tokens) and
    # --iters to nvme and ssd2gpu; ssd2host runs 2 alternating passes; the
    # format-bound phases always use their generated fixtures
    common = dict(file=None, size=size, block=args.block, depth=args.depth,
                  iters=1, engine=args.engine, tmpdir=args.tmpdir, json=True,
                  device=getattr(args, "device", None))
    byte_file = dict(file=args.file, iters=args.iters)
    phases = [
        ("nvme", bench_nvme, dict(buffered=False, huge=False, numa_node=-1,
                                  per_op=False, sqpoll=False, **byte_file)),
        ("ssd2host", bench_ssd2host, dict(file=args.file, iters=2)),
        ("ssd2host_raid", bench_ssd2host, dict(file=args.file, iters=2,
                                               raid=4,
                                               raid_chunk=512 * 1024)),
        ("ssd2gpu", bench_ssd2gpu, dict(chunk=min(32 * 1024 * 1024, size),
                                        prefetch=2, **byte_file)),
        ("llama", bench_llama, dict(batch=8, seq_len=2047, steps=8,
                                    prefetch=6, train_step=True,
                                    model="small", attn="flash",
                                    file=args.file)),
        ("resnet", bench_resnet, dict(batch=32, image_size=176, steps=6,
                                      prefetch=2, decode_workers=8,
                                      train_step=True, model="resnet50")),
        ("resnet_predecoded", bench_resnet,
         dict(batch=32, image_size=176, steps=6, prefetch=8,
              decode_workers=8, train_step=True, model="resnet50",
              predecoded=True)),
        ("vit", bench_vit, dict(batch=32, image_size=176, steps=6, prefetch=2,
                                decode_workers=8, raid=4,
                                raid_chunk=512 * 1024, train_step=True,
                                model="vit_b16")),
        ("parquet", bench_parquet, dict(rows=500_000, row_groups=16,
                                        prefetch=2, unit_batch=4, raid=0,
                                        raid_chunk=512 * 1024)),
        ("parquet_raid0", bench_parquet, dict(rows=500_000, row_groups=16,
                                              prefetch=2, unit_batch=4,
                                              raid=4,
                                              raid_chunk=512 * 1024,
                                              disk_rate=True)),
        ("parquet_wide", bench_parquet, dict(rows=200_000, row_groups=8,
                                             prefetch=2, unit_batch=4,
                                             raid=0, raid_chunk=512 * 1024,
                                             columns=16, cpu_device=True)),
        ("parquet_plain", bench_parquet, dict(rows=200_000, row_groups=4,
                                              prefetch=4, unit_batch=1,
                                              raid=0, raid_chunk=512 * 1024,
                                              columns=16, cpu_device=True,
                                              compression="none",
                                              dtype="float32",
                                              disk_rate=True)),
    ]
    out: dict = {"bench": "all", "failed": []}
    for name, fn, extra in phases:
        try:
            t0 = time.perf_counter()
            out[name] = fn(argparse.Namespace(**{**common, **extra}))
            out[name]["wall_s"] = round(time.perf_counter() - t0, 1)
        except Exception as e:  # noqa: BLE001 - the matrix goes on; the phase is named in "failed" and main() exits 3
            out[name] = {"error": repr(e)}
            out["failed"].append(name)
            print(f"bench {name} failed: {e!r}", file=sys.stderr)
    return out


def _add_decode_flags(p: argparse.ArgumentParser) -> None:
    """The decode A/B flags of the JPEG vision arms (default: every
    optimisation on, as StromConfig has them)."""
    p.add_argument("--full-decode", action="store_true", dest="full_decode",
                   help="disable reduced-scale JPEG decode (the 1/2, 1/4, "
                        "1/8 IDCT route chosen from the SOF header)")
    p.add_argument("--no-slot-decode", action="store_true",
                   dest="no_slot_decode",
                   help="disable decode into the batch slot: workers return "
                        "rows and the batch is stacked")
    p.add_argument("--no-overlap-put", action="store_true",
                   dest="no_overlap_put",
                   help="decode the whole batch, then copy it to the device")
    p.add_argument("--no-stream", action="store_true", dest="no_stream",
                   help="disable intra-batch streaming: the gather-all, "
                        "decode-all, put-all barrier path (the same "
                        "batches)")
    p.add_argument("--stream", action="store_true", dest="stream",
                   help="enable intra-batch streaming explicitly (the "
                        "default; pairs with --no-stream in A/B scripts)")
    p.add_argument("--no-native-decode", action="store_true",
                   dest="no_native_decode",
                   help="decode through cv2 instead of the libjpeg-turbo "
                        "binding (the same pixels)")
    p.add_argument("--no-fuse-decode", action="store_true",
                   dest="no_fuse_decode",
                   help="one pool task a sample instead of fused runs")
    p.add_argument("--no-roi-decode", action="store_true",
                   dest="no_roi_decode",
                   help="decode the full (or reduced) frame before the crop")
    p.add_argument("--decode-cache", action="store_true",
                   dest="decode_cache",
                   help="keep decoded frames in the hot cache (needs "
                        "--hot-cache): later epochs pay only crop and "
                        "resize")
    p.add_argument("--no-decode2-phases", action="store_true",
                   dest="no_decode2",
                   help="skip the native-vs-cv2 epochs and the decoded-"
                        "cache pair")


def _add_cache_flags(p: argparse.ArgumentParser) -> None:
    """The hot-cache knobs of the vision arms and the daemon (default off)."""
    p.add_argument("--hot-cache", type=int, nargs="?",
                   const=256 * 1024 * 1024, default=0,
                   dest="hot_cache_bytes", metavar="BYTES",
                   help="enable the hot-set host cache with this byte "
                        "budget (no value: 256MiB); adds a cold/warm epoch "
                        "pair to the output")
    p.add_argument("--no-hot-cache", action="store_true", dest="no_hot_cache",
                   help="force the cache off (overrides --hot-cache)")
    p.add_argument("--hot-cache-admit", default="second_touch",
                   choices=["second_touch", "always"], dest="hot_cache_admit",
                   help="admission: second_touch (the first epoch observes) "
                        "or always (admit on the first read)")
    p.add_argument("--readahead-window", type=int, default=0,
                   dest="readahead_window", metavar="BATCHES",
                   help="warm the sampler's next N batches into the hot "
                        "cache from a background thread (0 = off; needs "
                        "--hot-cache)")


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the reference's subcommands and flags,
    ``ssd2tpu`` named ``ssd2gpu``, and ``--device``."""
    ap = argparse.ArgumentParser(prog="strom-torch-bench")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--file", default=None, help="benchmark file (default: generated)")
        p.add_argument("--size", type=int, default=1 << 30, help="bytes to read")
        p.add_argument("--block", type=int, default=128 * 1024, help="I/O block size")
        p.add_argument("--depth", type=int, default=32, help="queue depth")
        p.add_argument("--iters", type=int, default=3)
        p.add_argument("--engine", default="auto", choices=["auto", "uring", "python"])
        p.add_argument("--tmpdir", default=os.environ.get("STROM_BENCH_DIR", "/tmp"))
        p.add_argument("--json", action="store_true", help="print one JSON line only")
        p.add_argument("--device", default=None,
                       help="the target device (default: the current CUDA "
                            "device; without one the arm raises). 'cpu' "
                            "runs the arm on the CPU")
        p.add_argument("--metrics-port", type=int, default=0,
                       dest="metrics_port",
                       help="serve /metrics, /stats and /trace on "
                            "127.0.0.1:<port> while the bench runs (0 = off)")
        p.add_argument("--trace-out", default=None, dest="trace_out",
                       help="dump the event ring as Trace Event JSON here "
                            "when the bench finishes (chrome://tracing, "
                            "ui.perfetto.dev)")
        p.add_argument("--flight-dir", default=os.environ.get(
                           "STROM_FLIGHT_DIR", ""), dest="flight_dir",
                       help="arm the flight recorder: an atomic crash bundle "
                            "here on SIGTERM, an unhandled exception or a "
                            "stalled run (empty = off)")
        p.add_argument("--flight-stall-s", type=float, default=30.0,
                       dest="flight_stall_s",
                       help="the flight recorder's no-progress threshold in "
                            "seconds (<= 0 disables the stall trigger)")
        p.add_argument("--fault-plan", default="", dest="fault_plan",
                       help="run under seeded fault injection: a JSON plan "
                            "file, an inline JSON object, or 'chaos[:seed]'")
        p.add_argument("--debug-locks", action="store_true",
                       dest="debug_locks",
                       help="run with the lock-order witness on (an "
                            "inversion raises LockOrderError; also "
                            "STROM_DEBUG_LOCKS=1)")

    p_nvme = sub.add_parser("nvme", help="O_DIRECT seq read -> host RAM")
    common(p_nvme)
    p_nvme.add_argument("--buffered", action="store_true",
                        help="use the page-cache path instead of O_DIRECT")
    p_nvme.add_argument("--huge", action="store_true",
                        help="MAP_HUGETLB destination slab (normal pages "
                             "where none are reserved)")
    p_nvme.add_argument("--numa-node", type=int, default=-1, dest="numa_node",
                        help="pin the submit thread and bind the dest slab "
                             "to this NUMA node (-1 = off)")
    p_nvme.add_argument("--per-op", action="store_true", dest="per_op",
                        help="one submit and wait a block instead of the "
                             "vectored gather")
    p_nvme.add_argument("--sqpoll", action="store_true",
                        help="IORING_SETUP_SQPOLL ring (falls back when "
                             "refused)")
    p_nvme.add_argument("--warm", action="store_true",
                        help="warm the page cache each iter instead of "
                             "dropping it (the residency hybrid's A/B arm; "
                             "pair with STROM_RESIDENCY_HYBRID=0)")
    p_nvme.set_defaults(fn=bench_nvme)

    p_s2h = sub.add_parser("ssd2host",
                           help="the delivered path's host ratio: raw engine "
                                "read vs the delivered path up to the "
                                "device copy (alternating arms, best of N)")
    common(p_s2h)
    p_s2h.add_argument("--raid", type=int, default=0,
                       help="measure on a RAID0 striped set of this many "
                            "members")
    p_s2h.add_argument("--raid-chunk", type=int, default=512 * 1024,
                       dest="raid_chunk", help="RAID0 chunk size")
    p_s2h.set_defaults(fn=bench_ssd2host, iters=4)

    p_s2g = sub.add_parser("ssd2gpu", help="async SSD->GPU copy loop")
    common(p_s2g)
    p_s2g.add_argument("--chunk", type=int, default=64 * 1024 * 1024,
                       help="bytes per async copy")
    p_s2g.add_argument("--prefetch", type=int, default=2, help="copies in flight")
    p_s2g.set_defaults(fn=bench_ssd2gpu)

    def bounded_flags(p):
        p.add_argument("--bounded-steps", type=int, default=0,
                       dest="bounded_steps",
                       help="with --train-step: an extra phase of this many "
                            "steps with a consumer paced at the measured "
                            "step time, at --bounded-prefetch depth (0 = off)")
        p.add_argument("--bounded-prefetch", type=int, default=4,
                       dest="bounded_prefetch",
                       help="prefetch depth of the paced phase")
        p.add_argument("--auto-prefetch", action="store_true",
                       dest="auto_prefetch",
                       help="move the prefetch depth in the --train-step "
                            "phase (grow on stalls, shrink on ample lead; "
                            "--prefetch is the start)")

    p_llama = sub.add_parser("llama", help="packed-token loader tokens/s")
    common(p_llama)
    p_llama.add_argument("--batch", type=int, default=32)
    p_llama.add_argument("--seq-len", type=int, default=2047, dest="seq_len")
    p_llama.add_argument("--steps", type=int, default=50)
    p_llama.add_argument("--prefetch", type=int, default=2)
    p_llama.add_argument("--train-step", action="store_true", dest="train_step",
                         help="phase 2: the captured train step consumes "
                              "the batches (the data-stall measurement)")
    p_llama.add_argument("--model", default="small", choices=["tiny", "small"],
                         help="LlamaConfig preset for --train-step")
    p_llama.add_argument("--attn", default="flash", choices=["dense", "flash"],
                         help="attention path for --train-step")
    bounded_flags(p_llama)
    p_llama.set_defaults(fn=bench_llama)

    def vision(name, help_, model_default, models, raid):
        p = sub.add_parser(name, help=help_)
        common(p)
        p.add_argument("--batch", type=int, default=64)
        p.add_argument("--image-size", type=int, default=224, dest="image_size")
        p.add_argument("--steps", type=int, default=20)
        p.add_argument("--prefetch", type=int, default=2)
        p.add_argument("--decode-workers", type=int, default=8, dest="decode_workers")
        if raid:
            p.add_argument("--raid", type=int, default=4,
                           help="RAID0 member count")
            p.add_argument("--raid-chunk", type=int, default=512 * 1024,
                           dest="raid_chunk", help="RAID0 chunk size")
        p.add_argument("--train-step", action="store_true", dest="train_step",
                       help="also run the captured train step over the "
                            "loader (the data-stall measurement)")
        p.add_argument("--model", default=model_default, choices=models,
                       help="model config for --train-step")
        p.add_argument("--predecoded", action="store_true",
                       help="decode-free loader over a shard the tar was "
                            "decoded into once")
        bounded_flags(p)
        _add_decode_flags(p)
        _add_cache_flags(p)
        return p

    vision("resnet", "JPEG loader images/s", "resnet50",
           ["tiny", "resnet50"], False).set_defaults(fn=bench_resnet)
    vision("vit", "WDS .tar -> ViT loader images/s over a RAID0 striped set",
           "vit_b16", ["tiny", "vit_b16"], True).set_defaults(fn=bench_vit)

    p_pq = sub.add_parser("parquet", help="columnar scan rows/s")
    common(p_pq)
    p_pq.add_argument("--rows", type=int, default=2_000_000)
    p_pq.add_argument("--row-groups", type=int, default=32, dest="row_groups")
    p_pq.add_argument("--prefetch", type=int, default=2)
    p_pq.add_argument("--unit-batch", type=int, default=1, dest="unit_batch",
                      help="row groups packed into one device call (the "
                           "aggregates are row-decomposable)")
    p_pq.add_argument("--raid", type=int, default=0,
                      help="scan from a RAID0 striped set of this many "
                           "members (0 = plain file)")
    p_pq.add_argument("--raid-chunk", type=int, default=512 * 1024,
                      dest="raid_chunk", help="RAID0 chunk size")
    p_pq.add_argument("--columns", type=int, default=1,
                      help="select this many columns (value + N-1 feature "
                           "columns): the wide projection")
    p_pq.add_argument("--cpu-device", action="store_true", dest="cpu_device",
                      help="run the aggregate on the CPU")
    p_pq.add_argument("--compression", default="snappy",
                      choices=["snappy", "none"],
                      help="the generated fixture's compression; 'none' "
                           "writes PLAIN chunks (ignored with --file)")
    p_pq.add_argument("--disk-rate", action="store_true", dest="disk_rate",
                      help="also time a bare engine gather of the same "
                           "bytes (disk_read_gbps, vs_disk)")
    p_pq.add_argument("--dtype", default="float64",
                      choices=["float64", "float32"],
                      help="the generated fixture's value/feature dtype")
    p_pq.add_argument("--pushdown", action="store_true",
                      help="also run the predicate pushdown A/B over a "
                           "monotone-keyed fixture (pushdown_ok)")
    p_pq.add_argument("--pushdown-selectivity", type=float, default=0.25,
                      dest="pushdown_selectivity",
                      help="fraction of rows the pushed predicate keeps")
    p_pq.set_defaults(fn=bench_parquet)

    p_all = sub.add_parser("all", help="every configuration at quick shapes, "
                                       "one combined JSON; exit 3 if any "
                                       "phase fails")
    common(p_all)
    p_all.set_defaults(fn=bench_all, size=256 * 1024 * 1024)

    p_mt = sub.add_parser(
        "multitenant",
        help="2 vision + 1 parquet tenant concurrently on ONE context "
             "through the scheduler (mt_<tenant>_* columns)")
    common(p_mt)
    p_mt.add_argument("--batch", type=int, default=8)
    p_mt.add_argument("--image-size", type=int, default=64, dest="image_size")
    p_mt.add_argument("--steps", type=int, default=6,
                      help="timed batches per vision tenant")
    p_mt.add_argument("--rows", type=int, default=200_000,
                      help="parquet fixture rows")
    p_mt.add_argument("--pq-iters", type=int, default=2, dest="pq_iters",
                      help="full scans the parquet tenant runs")
    p_mt.set_defaults(fn=bench_multitenant)

    p_chaos = sub.add_parser(
        "chaos",
        help="the resnet JPEG loader clean, then under a seeded fault plan "
             "(chaos_* columns)")
    common(p_chaos)
    p_chaos.add_argument("--batch", type=int, default=16)
    p_chaos.add_argument("--image-size", type=int, default=64,
                         dest="image_size")
    p_chaos.add_argument("--steps", type=int, default=6)
    p_chaos.add_argument("--prefetch", type=int, default=2)
    p_chaos.add_argument("--decode-workers", type=int, default=4,
                         dest="decode_workers")
    p_chaos.add_argument("--seed", type=int, default=0,
                         help="fault-plan seed when --fault-plan is unset")
    p_chaos.set_defaults(fn=bench_chaos)

    p_ckpt = sub.add_parser(
        "checkpoint",
        help="engine checkpoint save/restore of the llama train state vs "
             "pickle, and a spill epoch pair (ckpt_*/spill_* columns)")
    common(p_ckpt)
    p_ckpt.add_argument("--model", default="small",
                        choices=["tiny", "small", "llama3_8b"],
                        help="LlamaConfig preset whose train state is "
                             "checkpointed")
    p_ckpt.set_defaults(fn=bench_checkpoint)

    p_res = sub.add_parser(
        "resume",
        help="async-save stall vs the blocking save wall, then a kill/"
             "restart cycle (ckpt_async_*/resume_* columns)")
    common(p_res)
    p_res.add_argument("--model", default="small",
                       choices=["tiny", "small", "llama3_8b"],
                       help="LlamaConfig preset of the saved train state")
    p_res.add_argument("--saves", type=int, default=4,
                       help="async saves to measure")
    p_res.add_argument("--seed", type=int, default=0,
                       help="harness seed (kill step + fixture)")
    p_res.add_argument("--signal", default="KILL",
                       choices=["KILL", "TERM"],
                       help="how the victim trainer dies")
    p_res.set_defaults(fn=bench_resume)

    p_dist = sub.add_parser(
        "dist",
        help="the distributed data plane: an N-process ingest over an "
             "engine-written token fixture, each worker with its own "
             "engine, cache and peer server (a row hot on its owner "
             "reaches the others over the socket, not as a second SSD "
             "read). dist_ok=1: every worker bit-identical to the "
             "single-process reference (keys: "
             "strom_torch.dist.peers.DIST_BENCH_FIELDS)")
    common(p_dist)
    p_dist.add_argument("--procs", type=int, default=2,
                        help="worker processes (each its own engine, "
                             "cache and peer server)")
    p_dist.add_argument("--steps", type=int, default=6)
    p_dist.add_argument("--batch", type=int, default=16,
                        help="global batch rows a step (split over the "
                             "workers)")
    p_dist.add_argument("--seq-len", type=int, dest="seq_len", default=64)
    p_dist.add_argument("--files", type=int, default=4,
                        help="fixture shard files (owned by the ring's "
                             "members)")
    p_dist.add_argument("--records", type=int, default=128,
                        help="rows a fixture shard")
    p_dist.add_argument("--seed", type=int, default=0)
    p_dist.add_argument("--mode", default="host", choices=["host", "mesh"],
                        help="host = the rows in host memory (no device); "
                             "mesh = one worker a card over "
                             "torch.distributed, each slice delivered with "
                             "memcpy_ssd2gpu(sharding=)")
    p_dist.add_argument("--devices-per-proc", type=int,
                        dest="devices_per_proc", default=1,
                        help="devices a worker (mesh mode: 1, one process "
                             "a card; anything else raises)")
    p_dist.add_argument("--peer-compress", action="store_true",
                        dest="peer_compress",
                        help="also rerun the fleet with the compressed peer "
                             "wire: the same rows, compressed against raw "
                             "wire bytes")
    p_dist.add_argument("--batch-ab", action="store_true", dest="batch_ab",
                        help="also rerun the fleet with the batched "
                             "transport off: dist_batch_vs_single = the "
                             "batched rate over the one-extent-a-round-trip "
                             "rate")
    p_dist.set_defaults(fn=bench_dist)

    p_tune = sub.add_parser(
        "tune",
        help="the knob autotuner: the same shuffled block reads on hand "
             "knobs vs after the search (tuned_vs_hand)")
    common(p_tune)
    p_tune.add_argument("--cache-bytes", type=int, default=32 << 20,
                        dest="cache_bytes",
                        help="hot-cache budget the cache knob searches "
                             "around")
    p_tune.add_argument("--trials", type=int, default=16,
                        help="controller beats (one measured epoch each)")
    p_tune.add_argument("--profile", default="",
                        help="tune profile JSON: loaded before the search "
                             "when it exists, saved after")
    p_tune.set_defaults(fn=bench_tune, size=128 * 1024 * 1024, iters=3)

    p_daemon = sub.add_parser(
        "daemon",
        help="long-lived delivery daemon: /metrics /stats /trace /flight "
             "/tenants on --metrics-port (0 = ephemeral, printed on the "
             "ready line); SIGTERM/SIGINT drains every tenant")
    p_daemon.add_argument("--metrics-port", type=int, default=0,
                          dest="metrics_port")
    p_daemon.add_argument("--engine", default="auto",
                          choices=["auto", "uring", "python"])
    p_daemon.add_argument("--flight-dir", default=os.environ.get(
                              "STROM_FLIGHT_DIR", ""), dest="flight_dir")
    p_daemon.add_argument("--flight-stall-s", type=float, default=30.0,
                          dest="flight_stall_s")
    p_daemon.add_argument("--drain-timeout", type=float, default=10.0,
                          dest="drain_timeout",
                          help="seconds to wait for tenant queues and grants "
                               "to empty on shutdown")
    p_daemon.add_argument("--tune", action="store_true",
                          help="arm the knob autotuner (GET /tune)")
    p_daemon.add_argument("--profile", default="",
                          help="tune profile JSON: warm start, saved on "
                               "shutdown (with --tune)")
    _add_cache_flags(p_daemon)
    p_daemon.set_defaults(fn=cmd_daemon)

    p_check = sub.add_parser("check", help="report a file's data-path tier")
    p_check.add_argument("path")
    p_check.add_argument("--json", action="store_true")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "check":
        from strom_torch.probe.check import check_file

        try:
            rep = check_file(args.path)
        except OSError as e:
            print(f"strom-torch-bench check: {args.path}: {e.strerror or e}",
                  file=sys.stderr)
            return 2
        d = {"path": rep.path, "size": rep.size, "fs": rep.fs_type,
             "tier": rep.tier.value, "supported": rep.supported,
             "dio": vars(rep.dio), "extents": rep.extents,
             "cached_frac": rep.cached_frac,
             "reasons": list(rep.reasons)}
        print(json.dumps(d, indent=None if args.json else 2))
        return 0
    # under a launcher (torch.distributed.run sets WORLD_SIZE) every
    # process joins the group, one card each, and rank 0 alone reports
    launched = "WORLD_SIZE" in os.environ
    if launched:
        from strom_torch.parallel import mesh

        mesh.init_distributed("cpu" if getattr(args, "device", None) == "cpu"
                              else None)
    out = args.fn(args)
    if launched:
        # not on an error: a rank that raised leaves, and the launcher
        # stops the rest, rather than every rank waiting at a barrier
        mesh.shutdown()
        if int(os.environ.get("RANK", 0)) != 0:
            return 3 if out.get("failed") else 0
    if getattr(args, "trace_out", None):
        from strom_torch.obs.chrome_trace import dump

        # an unwritable trace path must not sink the finished result
        try:
            print(f"trace written to {dump(args.trace_out)} "
                  f"(load in chrome://tracing or ui.perfetto.dev)",
                  file=sys.stderr)
        except OSError as e:
            print(f"trace dump to {args.trace_out} failed: {e}",
                  file=sys.stderr)
    print(json.dumps(out))
    # a failed phase of the matrix fails the process
    return 3 if out.get("failed") else 0


if __name__ == "__main__":
    sys.exit(main())
