"""N-process distributed data plane: the launcher and the per-host worker
(the port's counterpart of ``strom/dist/launch.py``).

N worker processes, each owning

- a deterministic shard of the dataset: file-level ownership from the
  consistent-hash :class:`~strom_torch.dist.directory.ExtentDirectory`
  every process builds from the same membership, with no coordination;
- a :class:`~strom_torch.delivery.core.StromContext` of its own (engine,
  hot cache, scheduler) that warms its owned files into the hot cache,
  serves them to peers over the :mod:`strom_torch.dist.peers` extent
  service, and asks the owner for rows of a file another host owns: an
  extent hot on host A reaches host B over the socket, and host B's
  engine reads no byte of it;
- barriers: files in the rendezvous directory in host mode, and
  :func:`strom_torch.parallel.multihost.epoch_barrier` over
  ``torch.distributed`` in mesh mode.

Every process computes the same seeded global row order, and each
gathers only the rows backing its slice of each global batch:

- host mode: a numpy block through ``memcpy_ssd2host`` over the slice's
  :class:`ExtentList` (no device);
- mesh mode: one process a card. ``mesh.init_distributed`` joins an NCCL
  group, one ``dp`` mesh spans the ranks, and ``memcpy_ssd2gpu(ext,
  sharding=P("dp", None))`` of the whole batch reads only this rank's
  rows onto its card; the rank hashes its local block moved to the host
  in row order. One device a process: ``devices_per_proc`` other than 1
  raises, and so does mesh mode without CUDA.

Bit identity: each worker sha256-hashes its consumed rows in order, and
:func:`reference_shard_hashes` computes the same hashes from plain numpy
reads of the files, so a divergence in the shard math, the peer bytes or
a fallback read fails the run.

One worker: ``python -m strom_torch.dist.launch --rank R --nproc N ...``;
:func:`launch_local` spawns and joins all N; :func:`measure_ingest` is
the one call the CLI's ``dist`` arm and ``chip_smoke.py`` use.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

RECORD_DTYPE = np.int32


# -- rendezvous (files in the work directory) --------------------------------

def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def rendezvous(workdir: str, phase: str, rank: int, nproc: int,
               payload: str = "", timeout_s: float = 60.0) -> list[str]:
    """Publish *payload* under ``<phase>_<rank>`` and block until every
    rank has published; returns all payloads in rank order. With empty
    payloads it is a barrier."""
    os.makedirs(workdir, exist_ok=True)
    _atomic_write(os.path.join(workdir, f"{phase}_{rank}"), payload)
    deadline = time.monotonic() + timeout_s
    out: list[str] = []
    while True:
        out = []
        for r in range(nproc):
            p = os.path.join(workdir, f"{phase}_{r}")
            try:
                with open(p) as f:
                    out.append(f.read())
            except OSError:
                # a rank that died mid-run (the kill-a-host injection)
                # left a dead_<rank> marker on its way out: it satisfies
                # every later barrier with an empty payload, so the
                # survivors finish instead of timing out
                if os.path.exists(os.path.join(workdir, f"dead_{r}")):
                    out.append("")
                    continue
                break
        if len(out) == nproc:
            return out
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"rendezvous '{phase}': {len(out)}/{nproc} ranks after "
                f"{timeout_s}s")
        time.sleep(0.02)


# -- the shard and sampler math (every process computes the same) -----------

def dataset_layout(paths: "list[str]", seq_len: int):
    """(record_counts, cumulative_starts, rec_bytes) over sorted *paths*.
    Records are fixed-size ``seq_len`` int32 rows; a trailing partial row
    is ignored, as the token pipelines ignore it."""
    rec_bytes = seq_len * RECORD_DTYPE().itemsize
    counts = [os.path.getsize(p) // rec_bytes for p in paths]
    starts = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    return counts, starts, rec_bytes


def owner_of(paths: "list[str]", nproc: int) -> dict:
    """path → owning rank, from the balanced file-size assignment
    (``multihost.assign_balanced``: deterministic, no coordination)."""
    from strom_torch.parallel.multihost import assign_balanced

    sizes = [os.path.getsize(p) for p in paths]
    bins = assign_balanced(sizes, nproc)
    return {paths[i]: r for r, b in enumerate(bins) for i in b}


def global_row_order(total: int, need: int, seed: int) -> np.ndarray:
    """The first *need* rows of the seeded epoch-concatenated shuffle: the
    same stream on every process, each epoch permuted on its own."""
    rng = np.random.default_rng(seed)
    chunks = []
    got = 0
    while got < need:
        chunks.append(rng.permutation(total))
        got += total
    return np.concatenate(chunks)[:need]


def _row_extent(row: int, paths, starts, rec_bytes):
    f = int(np.searchsorted(starts, row, side="right")) - 1
    return paths[f], int(row - starts[f]) * rec_bytes


def reference_shard_hashes(paths: "list[str]", seq_len: int, nproc: int,
                           batch: int, steps: int, seed: int
                           ) -> list[str]:
    """Per-rank sha256 of the rows each host must consume, from plain
    numpy reads (no engine, no cache, no peers): the bit-identity
    oracle."""
    counts, starts, rec_bytes = dataset_layout(paths, seq_len)
    arrays = [np.fromfile(p, dtype=RECORD_DTYPE)[: c * seq_len]
              .reshape(c, seq_len) for p, c in zip(paths, counts)]
    order = global_row_order(int(starts[-1]), batch * steps, seed)
    per_host = batch // nproc
    hashes = [hashlib.sha256() for _ in range(nproc)]
    for step in range(steps):
        rows = order[step * batch: (step + 1) * batch]
        for r in range(nproc):
            for row in rows[r * per_host: (r + 1) * per_host]:
                f = int(np.searchsorted(starts, row, side="right")) - 1
                hashes[r].update(arrays[f][row - starts[f]].tobytes())
    return [h.hexdigest() for h in hashes]


# -- the worker --------------------------------------------------------------

def check_mode(mode: str, devices_per_proc: int) -> None:
    """Mesh mode runs one process a card: a *devices_per_proc* other than 1
    raises, and so does mesh mode without CUDA (it never runs on the
    CPU). Host mode takes any machine."""
    if mode not in ("host", "mesh"):
        raise ValueError(f"mode must be 'host' or 'mesh', got {mode!r}")
    if mode != "mesh":
        return
    if devices_per_proc != 1:
        raise ValueError("mesh mode runs one process a card: "
                         f"devices_per_proc {devices_per_proc} is not 1")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("dist mesh mode needs CUDA: one process a card "
                           "(host mode runs without a device)")


def _ext_of(rows, paths, starts, rec_bytes):
    from strom_torch.delivery.extents import ExtentList

    return ExtentList([_row_extent(int(r), paths, starts, rec_bytes)
                       + (rec_bytes,) for r in rows])


def run_worker(args: argparse.Namespace) -> dict:
    """One host of the data plane; returns the result dict it also writes
    to ``<workdir>/result_<rank>.json``."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.dist.directory import ExtentDirectory
    from strom_torch.utils.stats import global_stats

    rank, nproc = args.rank, args.nproc
    paths = sorted(os.path.join(args.data, f) for f in os.listdir(args.data)
                   if f.endswith(".bin"))
    if not paths:
        raise RuntimeError(f"no .bin shards under {args.data}")
    counts, starts, rec_bytes = dataset_layout(paths, args.seq_len)
    per_host = args.batch // nproc
    if per_host * nproc != args.batch:
        raise ValueError(f"batch {args.batch} not divisible by {nproc}")
    check_mode(args.mode, args.devices_per_proc)
    mesh_mode = args.mode == "mesh"

    cfg = StromConfig(
        engine=args.engine, queue_depth=8, num_buffers=16,
        hot_cache_bytes=args.hot_cache_bytes, hot_cache_admit="always",
        fault_plan=args.fault_plan,
        # both halves of the compressed wire flip together: every server
        # compresses and every client asks
        peer_compress=args.peer_compress,
        # --batch-extents: the batched transport's chunk (0 = one extent a
        # round trip, the A/B arm); -1 keeps the config default
        **({"dist_batch_max_extents": args.batch_extents}
           if args.batch_extents >= 0 else {}),
        # a flight directory a rank: the coordinator's fleet watchdog
        # dumps a host-stamped bundle here when a peer goes dark
        flight_dir=os.path.join(args.workdir, f"flight_{rank}"))
    # metrics_port=0: an ephemeral port, so rank 0's ClusterView can
    # federate every worker
    ctx = StromContext(cfg, metrics_port=0)
    result: dict = {"rank": rank, "ok": 0, "mode": args.mode}
    joined = False
    try:
        addr = ctx.serve_peers()
        addrs = rendezvous(args.workdir, "peers", rank, nproc, addr,
                           timeout_s=args.timeout_s)
        peer_map = {r: a for r, a in enumerate(addrs) if r != rank}
        # every rank builds the same ring from the same membership; a
        # tripped peer's death is published through the work directory and
        # every survivor's throttled poll re-owns its keys mid-run
        directory = ExtentDirectory(range(nproc), rank,
                                    rendezvous_dir=args.workdir,
                                    poll_interval_s=0.05)
        ctx.attach_peers(peer_map, directory=directory)

        # every rank publishes its metrics address; rank 0 federates them
        # all (itself included) for the run's lifetime
        obs = rendezvous(
            args.workdir, "obs", rank, nproc,
            json.dumps({"metrics": f"127.0.0.1:{ctx.metrics_server.port}",
                        "peer": addr}),
            timeout_s=args.timeout_s)
        if rank == 0:
            hosts = {f"rank{r}": json.loads(o)["metrics"]
                     for r, o in enumerate(obs)}
            ctx.attach_cluster(hosts, interval_s=0.25, stall_s=5.0)

        if mesh_mode:
            from strom_torch.parallel import mesh as _mesh
            from strom_torch.parallel.sharding import P, TorchSharding

            ports = rendezvous(args.workdir, "coord", rank, nproc,
                               str(_pick_port()) if rank == 0 else "x",
                               timeout_s=args.timeout_s)
            _mesh.init_distributed(
                "cuda", rank=rank, world_size=nproc,
                init_method=f"tcp://127.0.0.1:{ports[0]}",
                timeout_s=args.timeout_s)
            joined = True
            sharding = TorchSharding(_mesh.make_mesh({"dp": nproc}),
                                     P("dp", None))
            # the first DTensor of a process (its modules' import and
            # dispatch) costs seconds: paid here, before the timed steps,
            # on a block of zeros that touches no data
            import torch

            sharding.to_global(torch.zeros(
                (per_host, args.seq_len), dtype=torch.int32,
                device=_mesh.group_device()), (args.batch, args.seq_len))

        # warm: the owner pays the SSD read for its files once (admission
        # "always": every byte lands hot); the barrier after it means the
        # ingest's peer probes find every owner warm
        for p, c in zip(paths, counts):
            if directory.ring_owner(p) == rank:
                ctx.pread(p, 0, c * rec_bytes)
        rendezvous(args.workdir, "warm", rank, nproc,
                   timeout_s=args.timeout_s)

        engine_warm_bytes = ctx.engine.stats().get("bytes_read", 0)
        delivered0 = global_stats.counter("ssd2gpu_bytes").value
        order = global_row_order(int(starts[-1]), args.batch * args.steps,
                                 args.seed)
        sha = hashlib.sha256()
        asm_us: list[float] = []
        rows_per_epoch = int(starts[-1])
        consumed = 0
        t0 = time.perf_counter()
        for step in range(args.steps):
            rows = order[step * args.batch: (step + 1) * args.batch]
            ta = time.perf_counter()
            if mesh_mode:
                from strom_torch.parallel.sharding import local_tensor

                # the whole batch as one ExtentList, delivered sharded:
                # this rank reads only the rows of its block (cache →
                # spill → peers → engine) onto its card
                batch_t = ctx.memcpy_ssd2gpu(
                    _ext_of(rows, paths, starts, rec_bytes),
                    shape=(args.batch, args.seq_len), dtype=RECORD_DTYPE,
                    sharding=sharding)
                local = local_tensor(batch_t).cpu().numpy()
            else:
                local = ctx.memcpy_ssd2host(
                    _ext_of(rows[rank * per_host: (rank + 1) * per_host],
                            paths, starts, rec_bytes),
                    shape=(per_host, args.seq_len), dtype=RECORD_DTYPE)
            asm_us.append((time.perf_counter() - ta) * 1e6)
            sha.update(np.ascontiguousarray(local).tobytes())
            if (args.die_after_step >= 0 and args.die_rank == rank
                    and step == args.die_after_step):
                # kill-a-host: publish the death marker (later barriers
                # count us, the survivors' ring polls re-own our keys) and
                # vanish with no cleanup, as a crashed host does
                _atomic_write(os.path.join(args.workdir, f"dead_{rank}"),
                              str(step))
                os._exit(17)
            prev_epoch, consumed = consumed // rows_per_epoch, \
                consumed + args.batch
            if consumed // rows_per_epoch != prev_epoch:
                # every host finishes the epoch before any starts the next
                if mesh_mode:
                    from strom_torch.parallel.multihost import epoch_barrier

                    epoch_barrier(f"dist-epoch-{consumed // rows_per_epoch}")
                else:
                    rendezvous(args.workdir,
                               f"epoch{consumed // rows_per_epoch}", rank,
                               nproc, timeout_s=args.timeout_s)
        wall = time.perf_counter() - t0
        # the exit barrier: a fast worker keeps its peer server up until
        # every worker has finished fetching (closing early turns a slower
        # host's tail into refused-connect fallbacks)
        rendezvous(args.workdir, "done", rank, nproc,
                   timeout_s=args.timeout_s)
        delivered = global_stats.counter("ssd2gpu_bytes").value - delivered0
        dist = ctx.stats(sections=["dist"]).get("dist", {})
        if rank == 0 and ctx.cluster_view is not None:
            # one last scrape with every worker alive; the federation's
            # gauges join the result
            ctx.cluster_view.poll_now()
            result.update(ctx.cluster_view.stats())
        # a trace file a host: the fleet's traces merge into one timeline
        # with cross-host flow arrows
        from strom_torch.obs import chrome_trace

        with contextlib.suppress(Exception):
            chrome_trace.dump(
                os.path.join(args.workdir, f"trace_{rank}.json"),
                meta={"host": f"rank{rank}", "peer_addr": addr})
        asm = sorted(asm_us)
        items = args.steps * per_host
        result.update({
            "ok": 1,
            "engine": ctx.engine.stats().get("engine"),
            "steps": args.steps,
            "items": items,
            "wall_s": round(wall, 4),
            "items_per_s": round(items / wall, 2) if wall else 0.0,
            "sha256": sha.hexdigest(),
            "ingest_bytes": items * rec_bytes,
            "engine_ingest_bytes":
                ctx.engine.stats().get("bytes_read", 0) - engine_warm_bytes,
            # the bytes this rank's deliveries carried: its own rows only
            # (a rank that gathered the whole batch would show nproc x)
            "delivered_bytes": delivered,
            "first_step_us": asm_us[0] if asm_us else 0.0,
            "assembly_wait_p50_us": asm[len(asm) // 2] if asm else 0.0,
            "assembly_wait_p99_us":
                asm[min(len(asm) - 1, int(0.99 * len(asm)))] if asm else 0.0,
            **dist,
        })
        if mesh_mode:
            import torch

            dev = _mesh.group_device()
            result["device"] = str(dev)
            result["card"] = torch.cuda.get_device_name(dev) \
                if dev.type == "cuda" else str(dev)
    finally:
        if joined:
            from strom_torch.parallel import mesh as _mesh

            with contextlib.suppress(Exception):
                _mesh.shutdown()
        ctx.close()
    _atomic_write(os.path.join(args.workdir, f"result_{rank}.json"),
                  json.dumps(result))
    return result


def _pick_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the launcher ------------------------------------------------------------

def launch_local(nproc: int, data_dir: str, workdir: str, *,
                 steps: int = 4, batch: int = 8, seq_len: int = 16,
                 seed: int = 0, engine: str = "python",
                 mode: str = "host", devices_per_proc: int = 1,
                 hot_cache_bytes: int = 64 * 1024 * 1024,
                 fault_plan: str = "", peer_compress: bool = False,
                 batch_extents: int = -1, die_rank: int = -1,
                 die_after_step: int = -1,
                 timeout_s: float = 120.0) -> list[dict]:
    """Spawn *nproc* workers over *data_dir*, join them, return their
    result dicts in rank order (a worker that left no result reads ``ok
    0`` with its output's tail). *batch_extents* overrides the batched
    transport's chunk (0 = unbatched, -1 = the config default);
    *die_rank*/*die_after_step* arm the kill-a-host injection (that worker
    exits uncleanly after the given step: its row reads ``ok 0, rc 17``).
    Every worker is killed if they have not all ended *timeout_s* + 60 s
    after the spawn. :func:`check_mode` runs first."""
    check_mode(mode, devices_per_proc)
    os.makedirs(workdir, exist_ok=True)
    for f in os.listdir(workdir):
        # rendezvous and result files of an earlier run in the same
        # directory would satisfy (or corrupt) this run's barriers
        if f.startswith(("peers_", "coord_", "warm_", "epoch", "done_",
                         "result_", "obs_", "trace_", "dead_",
                         "ring_dead_")):
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(workdir, f))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "strom_torch.dist.launch",
         "--rank", str(r), "--nproc", str(nproc), "--data", data_dir,
         "--workdir", workdir, "--steps", str(steps),
         "--batch", str(batch), "--seq-len", str(seq_len),
         "--seed", str(seed), "--engine", engine, "--mode", mode,
         "--devices-per-proc", str(devices_per_proc),
         "--hot-cache-bytes", str(hot_cache_bytes),
         "--timeout-s", str(timeout_s),
         "--batch-extents", str(batch_extents),
         "--die-rank", str(die_rank),
         "--die-after-step", str(die_after_step)]
        + (["--fault-plan", fault_plan] if fault_plan else [])
        + (["--peer-compress"] if peer_compress else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo, env=env) for r in range(nproc)]
    deadline = time.monotonic() + timeout_s + 60
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        path = os.path.join(workdir, f"result_{r}.json")
        try:
            with open(path) as f:
                res = json.load(f)
        except (OSError, json.JSONDecodeError):
            res = {"rank": r, "ok": 0}
        res["rc"] = p.returncode
        if p.returncode != 0 or not res.get("ok"):
            res["tail"] = out[-2000:]
        results.append(res)
    return results


def make_fixture(data_dir: str, *, files: int = 4, records: int = 48,
                 seq_len: int = 16, seed: int = 7) -> list[str]:
    """A small multi-file token fixture (plain ``tofile``; the CLI's arm
    writes its fixture through the engine's write path instead)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(files):
        p = os.path.join(data_dir, f"shard{i}.bin")
        rng.integers(0, 32000, (records, seq_len),
                     dtype=RECORD_DTYPE).tofile(p)
        paths.append(p)
    return paths


def measure_ingest(procs: int, workdir: str, *, data_dir: "str | None" = None,
                   steps: int = 4, batch: int = 8, seq_len: int = 16,
                   seed: int = 0, engine: str = "python",
                   mode: str = "host", devices_per_proc: int = 1,
                   hot_cache_bytes: int = 64 * 1024 * 1024,
                   fault_plan: str = "", peer_compress: bool = False,
                   batch_extents: int = -1, die_rank: int = -1,
                   die_after_step: int = -1,
                   timeout_s: float = 120.0) -> dict:
    """The acceptance in one call: launch *procs* workers, hold each one's
    rows to :func:`reference_shard_hashes`, and fold the rates and the
    peer traffic into the ``DIST_BENCH_FIELDS`` columns. With a kill armed
    (*die_rank* >= 0) the survivors are judged: each must exit clean and
    bit-identical, and the dead rank is expected to vanish.
    ``dist_only_own_rows`` is 1 when every judged worker's deliveries
    carried exactly its own rows' bytes."""
    if data_dir is None:
        data_dir = os.path.join(workdir, "data")
        make_fixture(data_dir, seq_len=seq_len)
    paths = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                   if f.endswith(".bin"))
    ref = reference_shard_hashes(paths, seq_len, procs, batch, steps, seed)
    results = launch_local(
        procs, data_dir, os.path.join(workdir, f"run{procs}"),
        steps=steps, batch=batch, seq_len=seq_len, seed=seed, engine=engine,
        mode=mode, devices_per_proc=devices_per_proc,
        hot_cache_bytes=hot_cache_bytes, fault_plan=fault_plan,
        peer_compress=peer_compress, batch_extents=batch_extents,
        die_rank=die_rank, die_after_step=die_after_step,
        timeout_s=timeout_s)
    judged = [(i, r) for i, r in enumerate(results) if i != die_rank]
    ok = all(r.get("rc") == 0 and r.get("ok") for _, r in judged) and \
        all(r.get("sha256") == ref[i] for i, r in judged)
    walls = [r.get("wall_s", 0.0) for r in results if r.get("ok")]
    items = sum(r.get("items", 0) for r in results)
    hit = sum(r.get("peer_hit_bytes", 0) for r in results)
    served = sum(r.get("peer_served_bytes", 0) for r in results)
    ingest = sum(r.get("ingest_bytes", 0) for r in results)
    engine_bytes = sum(r.get("engine_ingest_bytes", 0) for r in results)
    # the servers' compression tallies (raw bytes in, wire bytes out): the
    # wire total puts what crossed the socket in place of the compressed
    # serves' logical bytes
    comp_in = sum(r.get("peer_comp_bytes_in", 0) for r in results)
    comp_out = sum(r.get("peer_comp_bytes_out", 0) for r in results)
    from strom_torch.obs.federation import FED_FIELDS

    rank0 = results[0] if results else {}
    return {
        "dist_ok": int(ok),
        "dist_procs": procs,
        # rank 0's ClusterView gauges (0 where the run was cut short)
        **{k: rank0.get(k, 0) for k in FED_FIELDS},
        "dist_steps": steps,
        "dist_items_per_s":
            round(items / max(walls), 2) if walls and max(walls) else 0.0,
        "dist_peer_hit_ratio":
            round(hit / ingest, 4) if ingest else 0.0,
        "dist_peer_hit_bytes": hit,
        "dist_peer_served_bytes": served,
        "dist_engine_ingest_bytes": engine_bytes,
        "dist_only_own_rows": int(bool(judged) and all(
            r.get("delivered_bytes") == r.get("ingest_bytes")
            for _, r in judged)),
        "dist_peer_comp_bytes_in": comp_in,
        "dist_peer_comp_bytes_out": comp_out,
        "dist_peer_wire_bytes": served - comp_in + comp_out,
        "peer_comp_ratio": round(comp_in / comp_out, 4) if comp_out else 0.0,
        "dist_assembly_wait_p99_us": round(max(
            (r.get("assembly_wait_p99_us", 0.0) for r in results),
            default=0.0), 1),
        "dist_peer_rtt_p99_us": round(max(
            (r.get("peer_rtt_p99_us", 0.0) for r in results),
            default=0.0), 1),
        # the worst worker's per-extent round trip, the decoded-frame
        # traffic, and how far the pools amortised their dials
        "peer_rtt_per_extent_us": round(max(
            (r.get("peer_rtt_per_extent_us", 0.0) for r in results),
            default=0.0), 1),
        "peer_frame_hit_bytes":
            sum(r.get("peer_frame_hit_bytes", 0) for r in results),
        "peer_conn_reuse_ratio": round(
            sum(r.get("peer_conn_reuses", 0) for r in results)
            / max(sum(r.get("peer_conn_opens", 0)
                      + r.get("peer_conn_reuses", 0) for r in results), 1),
            4),
        "workers": results,
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description="strom_torch dist worker")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, dest="seq_len", default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="python")
    ap.add_argument("--mode", choices=("host", "mesh"), default="host")
    ap.add_argument("--devices-per-proc", type=int,
                    dest="devices_per_proc", default=1)
    ap.add_argument("--hot-cache-bytes", type=int, dest="hot_cache_bytes",
                    default=64 * 1024 * 1024)
    ap.add_argument("--fault-plan", dest="fault_plan", default="")
    ap.add_argument("--peer-compress", dest="peer_compress",
                    action="store_true")
    ap.add_argument("--timeout-s", type=float, dest="timeout_s",
                    default=120.0)
    ap.add_argument("--batch-extents", type=int, dest="batch_extents",
                    default=-1)
    ap.add_argument("--die-rank", type=int, dest="die_rank", default=-1)
    ap.add_argument("--die-after-step", type=int, dest="die_after_step",
                    default=-1)
    args = ap.parse_args(argv)
    res = run_worker(args)
    print(json.dumps(res))
    return 0 if res.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
