"""Kill/restart recovery harness (the port's copy of
``strom/faults/resume_harness.py``).

The fault plans inject failures inside a live process. This harness
injects the failure a scheduler actually deals out: the whole process
dies, SIGKILLed mid-epoch with no cleanup and an async checkpoint commit
possibly in flight, and a fresh process must come back from
``last_committed`` and its StepToken and continue the exact batch stream.

Three subprocess runs of one deterministic trainer (``python -m
strom_torch.faults.resume_harness trainer``: engine-read token batches, a
tiny numpy train state, async snapshot-then-commit checkpoints every K
steps with the StepToken riding the manifest):

1. **reference**: uninterrupted; logs ``(serial, sha256(batch))`` a step,
   each line fsynced (the log survives any kill point).
2. **victim**: the same, but it sends itself SIGKILL (or SIGTERM) the
   moment the seeded kill step's batch is consumed.
3. **resume**: started with ``--resume``: recovers ``last_committed``,
   sweeps tmp orphans, restores the train state (CRC-verified) and the
   StepToken (``Pipeline.restore``), and runs to the end.

``resume_ok`` (``RESUME_FIELDS``, from ``strom_torch/ckpt/jobstate.py``)
folds the contract into one bit: the resumed stream is bit-identical to
the reference from the restart step on, the restart step equals the
committed token's serial (never the epoch's start), the final train state
matches the uninterrupted run's, and no tmp checkpoint survives.

    python -m strom_torch.faults.resume_harness run --workdir DIR [--seed N]

exits 0 when ``resume_ok``, and prints the verdict as one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

from strom_torch.ckpt.jobstate import RESUME_FIELDS, set_resume_gauges

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# -- the trainer subprocess ---------------------------------------------------
def _trainer(args: argparse.Namespace) -> int:
    t_start = time.perf_counter()
    from strom_torch.ckpt import (AsyncCheckpointer, clean_orphans,
                                  last_committed, restore_checkpoint)
    from strom_torch.ckpt.jobstate import (TOKEN_KEY, StepToken,
                                           restore_warm_state)
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.formats.rawbin import TokenShardSet
    from strom_torch.pipelines.base import Pipeline
    from strom_torch.pipelines.sampler import (EpochShuffleSampler,
                                               dataset_fingerprint)

    cache = args.cache_bytes > 0
    cfg = StromConfig(engine=args.engine, queue_depth=8, num_buffers=16,
                      slab_pool_bytes=32 << 20,
                      # a recovery trainer runs with retry headroom: the
                      # op-window fault tests inject transient EIO/short
                      # reads around the kill step and the harness's
                      # contract is that RETRIES absorb them, not luck
                      io_retries=3,
                      fault_plan=args.fault_plan,
                      hot_cache_bytes=args.cache_bytes,
                      hot_cache_admit="always" if cache else "second_touch",
                      spill_bytes=args.cache_bytes * 4 if cache else 0,
                      spill_dir=args.workdir if cache else "")
    ctx = StromContext(cfg)
    ckdir = os.path.join(args.workdir, "ckpt")
    log_path = os.path.join(args.workdir, f"batches_{args.tag}.log")
    meta_path = os.path.join(args.workdir, f"meta_{args.tag}.json")
    template = {"sum": np.zeros((), np.float64),
                "steps": np.zeros((), np.int64)}
    start_serial = 0
    orphans = 0
    warmed = 0
    train_state = {k: v.copy() for k, v in template.items()}
    token: "StepToken | None" = None
    if args.resume:
        lc = last_committed(ckdir)
        if lc is None:
            print("RESUME_ERROR no committed checkpoint", flush=True)
            return 4
        path, manifest = lc
        orphans = len(clean_orphans(ckdir))
        token = StepToken.from_manifest(manifest)
        if token is None:
            print("RESUME_ERROR checkpoint carries no StepToken", flush=True)
            return 4
        train_state = restore_checkpoint(ctx, path, template, verify=True)
        warmed = restore_warm_state(ctx, token.warm)
        start_serial = token.consumed

    shards = TokenShardSet((args.shard,), record_tokens=args.record_tokens)
    fp = dataset_fingerprint(shards.paths, ctx)
    # the sampler starts AT the token's cursor, so the prefetch window
    # __init__ opens dispatches the right serials from the first thunk;
    # restore() below then validates the token (fingerprint/seed) and
    # adopts its prefetch depth without discarding wrong-position reads
    sampler = EpochShuffleSampler(shards.num_records, args.batch,
                                  seed=args.seed,
                                  state=token.sampler if token is not None
                                  else None)

    def make_batch(indices: np.ndarray, serial: int):
        el = shards.extents(indices)
        data = ctx.pread(el)[: el.size]
        return serial, np.asarray(data)

    pipe = Pipeline(sampler, make_batch, depth=args.depth, fingerprint=fp)
    if token is not None:
        pipe.restore(token)
    assert int(np.asarray(train_state["steps"])) == start_serial, \
        "restored state serial != StepToken serial (atomicity broken)"

    cp = AsyncCheckpointer(ctx, ckdir)
    first_batch_s = None
    sig = getattr(signal, f"SIG{args.die_signal}")
    log = open(log_path, "a")
    try:
        for serial, batch in pipe:
            if first_batch_s is None:
                first_batch_s = time.perf_counter() - t_start
            h = hashlib.sha256(batch.tobytes()).hexdigest()[:24]
            # fsync per line: the log is the harness's witness and must be
            # complete up to the instant of an uncleanable SIGKILL
            log.write(f"{serial} {h}\n")
            log.flush()
            os.fsync(log.fileno())
            train_state["sum"] += float(batch.astype(np.int64).sum() % 99991)
            train_state["steps"] += 1
            consumed = serial + 1
            if args.ckpt_every > 0 and consumed % args.ckpt_every == 0 \
                    and consumed < args.steps:
                tok = pipe.token(ctx, warm_state=args.warm_hints)
                cp.save(train_state, extra={TOKEN_KEY: tok.to_dict()})
                if cp.commits == 0:
                    # the first checkpoint is drained synchronously: a
                    # job is only preemption-safe once ONE commit is
                    # durable, and the harness kills as early as
                    # ckpt_every+1 — later saves stay fully async (a
                    # SIGKILL mid-commit is part of the exercise)
                    cp.wait()
            if serial == args.die_at:
                os.kill(os.getpid(), sig)       # a real mid-epoch preemption
                time.sleep(30)                  # SIGTERM delivery window
            if consumed >= args.steps:
                break
    finally:
        log.close()
    cp.wait()
    cp.close()
    with open(meta_path + ".tmp", "w") as f:
        json.dump({"start_serial": start_serial,
                   "orphans_cleaned": orphans,
                   "warm_bytes": warmed,
                   "first_batch_s": round(first_batch_s or 0.0, 4),
                   "wall_s": round(time.perf_counter() - t_start, 4),
                   "ckpt_commits": cp.commits,
                   "final_sum": float(np.asarray(train_state["sum"])),
                   "final_steps": int(np.asarray(train_state["steps"]))}, f)
    os.replace(meta_path + ".tmp", meta_path)
    pipe.close()
    ctx.close()
    return 0


# -- the harness --------------------------------------------------------------
def _spawn_trainer(workdir: str, shard: str, *, tag: str, seed: int,
                   steps: int, batch: int, record_tokens: int,
                   ckpt_every: int, die_at: int, die_signal: str,
                   engine: str, fault_plan: str, warm_hints: bool,
                   cache_bytes: int, depth: int,
                   timeout_s: float) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "strom_torch.faults.resume_harness",
           "trainer",
           "--workdir", workdir, "--shard", shard, "--tag", tag,
           "--seed", str(seed), "--steps", str(steps),
           "--batch", str(batch), "--record-tokens", str(record_tokens),
           "--ckpt-every", str(ckpt_every), "--die-at", str(die_at),
           "--die-signal", die_signal, "--engine", engine,
           "--fault-plan", fault_plan, "--cache-bytes", str(cache_bytes),
           "--depth", str(depth)]
    if tag == "resume":
        cmd.append("--resume")
    if warm_hints:
        cmd.append("--warm-hints")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout_s, env=env, cwd=_REPO_ROOT)


def _read_log(workdir: str, tag: str) -> dict[int, str]:
    out: dict[int, str] = {}
    path = os.path.join(workdir, f"batches_{tag}.log")
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                out[int(parts[0])] = parts[1]
    return out


def run_kill_resume(workdir: str, *, seed: int = 0, steps: "int | None" = None,
                    batch: int = 4, records: int = 96,
                    record_tokens: int = 64, ckpt_every: int = 4,
                    sig: str = "KILL", engine: str = "python",
                    fault_plan: str = "", warm_hints: bool = False,
                    cache_bytes: int = 0, depth: int = 2,
                    timeout_s: float = 300.0) -> dict:
    """One full kill→restart→verify cycle. Returns the RESUME_FIELDS
    verdict dict (plus diagnostics); never raises on a failed contract:
    ``resume_ok=0`` with ``failures`` naming what broke. The kill step is
    a seeded draw strictly inside the first epoch, after at least one
    commit."""
    os.makedirs(workdir, exist_ok=True)
    ckdir = os.path.join(workdir, "ckpt")
    _wipe_cycle_state(workdir, ckdir)   # reruns must not mix prior logs
    bpe = records // batch
    if bpe < ckpt_every + 3:
        raise ValueError(f"records/batch = {bpe} batches/epoch is too few "
                         f"for ckpt_every={ckpt_every} + a mid-epoch kill")
    total = steps if steps is not None else bpe + max(bpe // 2, 2)
    rng = random.Random(seed)
    kill_step = rng.randrange(ckpt_every + 1, bpe - 1)

    shard = os.path.join(workdir, "tokens.bin")
    toks = np.random.default_rng(seed).integers(
        0, 1 << 15, records * record_tokens, dtype=np.int32)
    toks.tofile(shard)

    common = dict(seed=seed, steps=total, batch=batch,
                  record_tokens=record_tokens, ckpt_every=ckpt_every,
                  die_signal=sig, engine=engine, fault_plan=fault_plan,
                  warm_hints=warm_hints, cache_bytes=cache_bytes,
                  depth=depth, timeout_s=timeout_s)
    failures: list[str] = []

    def run(tag: str, die_at: int) -> subprocess.CompletedProcess:
        return _spawn_trainer(workdir, shard, tag=tag, die_at=die_at,
                              **common)

    ref = run("ref", -1)
    if ref.returncode != 0:
        failures.append(f"reference run rc={ref.returncode}: "
                        f"{ref.stderr[-400:]}")
    # the reference run's checkpoints must not be visible to the
    # victim/resume pair: a victim killed before ITS first commit lands
    # would otherwise "resume" from the reference's final state (a
    # restart serial way past kill_step — a spurious contract failure)
    _wipe_ckpt(ckdir)
    victim = run("victim", kill_step)
    signum = getattr(signal, f"SIG{sig}")
    if victim.returncode != -signum:
        failures.append(f"victim rc={victim.returncode}, expected "
                        f"-{signum} (killed by SIG{sig})")
    t0 = time.perf_counter()
    res = run("resume", -1)
    resume_wall = time.perf_counter() - t0
    if res.returncode != 0:
        failures.append(f"resume run rc={res.returncode}: "
                        f"{res.stdout[-200:]} {res.stderr[-400:]}")

    ref_log = _read_log(workdir, "ref")
    victim_log = _read_log(workdir, "victim")
    resume_log = _read_log(workdir, "resume")
    meta = {}
    meta_path = os.path.join(workdir, "meta_resume.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    ref_meta_path = os.path.join(workdir, "meta_ref.json")
    ref_meta = {}
    if os.path.exists(ref_meta_path):
        with open(ref_meta_path) as f:
            ref_meta = json.load(f)

    restart = int(meta.get("start_serial", -1))
    # pre-kill sanity: the victim's stream WAS the reference stream
    for s, h in victim_log.items():
        if ref_log.get(s) != h:
            failures.append(f"victim batch {s} diverged from reference")
            break
    # the resume contract: continue at exactly the committed token's
    # serial; bit-identical from there to the end; nothing skipped
    checked = 0
    if restart < 0:
        failures.append("resume run left no meta (never started?)")
    else:
        if restart <= 0 or restart > kill_step + 1:
            failures.append(f"restart serial {restart} outside "
                            f"(0, kill_step+1={kill_step + 1}]")
        expect = set(range(restart, total))
        got = set(resume_log)
        if got != expect:
            failures.append(f"resume consumed serials {sorted(got)[:4]}..; "
                            f"expected [{restart}, {total})")
        for s in sorted(expect & got):
            if resume_log[s] != ref_log.get(s):
                failures.append(f"resume batch {s} diverged from reference")
                break
            checked += 1
    # replay bound: only the un-checkpointed tail re-runs — never the epoch
    replayed = max(kill_step + 1 - restart, 0) if restart >= 0 else -1
    if replayed < 0 or replayed > 2 * ckpt_every:
        failures.append(f"replayed {replayed} batches > bound "
                        f"{2 * ckpt_every} (epoch replay?)")
    # end-state equivalence: resumed training computed the same final
    # state the uninterrupted run did (stream AND state resumed together)
    if ref_meta and meta and ref_meta.get("final_sum") != meta.get("final_sum"):
        failures.append(f"final state diverged: ref sum "
                        f"{ref_meta.get('final_sum')} != resumed "
                        f"{meta.get('final_sum')}")
    # no orphaned/corrupt checkpoints survive the cycle
    leftovers = glob.glob(f"{ckdir}.tmp-*") + glob.glob(f"{ckdir}.old-*")
    if leftovers:
        failures.append(f"orphaned checkpoint dirs survive: {leftovers}")

    results = {
        "resume_ok": int(not failures),
        "resume_kill_step": kill_step,
        "resume_restart_step": restart,
        "resume_replayed_batches": replayed,
        "resume_batches_checked": checked,
        "resume_orphan_tmps": int(meta.get("orphans_cleaned", 0)),
        "resume_ckpt_commits": int(meta.get("ckpt_commits", 0))
        + int(_read_meta_commits(workdir, "victim")),
        "resume_wall_s": round(resume_wall, 3),
        "resume_first_batch_s": meta.get("first_batch_s"),
        "resume_warm_bytes": meta.get("warm_bytes"),
        "resume_total_steps": total,
        "failures": failures,
    }
    assert set(RESUME_FIELDS) <= set(results)
    set_resume_gauges(results)
    return results


def _wipe_ckpt(ckdir: str) -> None:
    shutil.rmtree(ckdir, ignore_errors=True)
    for p in glob.glob(f"{ckdir}.tmp-*") + glob.glob(f"{ckdir}.old-*"):
        shutil.rmtree(p, ignore_errors=True)


def _wipe_cycle_state(workdir: str, ckdir: str) -> None:
    """Remove a previous cycle's artifacts: trainer logs are opened in
    append mode (the victim's must survive its own SIGKILL), so a rerun
    against the same --workdir would otherwise mix two cycles' serials
    into one verdict."""
    import contextlib

    _wipe_ckpt(ckdir)
    for tag in ("ref", "victim", "resume"):
        for name in (f"batches_{tag}.log", f"meta_{tag}.json"):
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(workdir, name))


def _read_meta_commits(workdir: str, tag: str) -> int:
    # the victim's meta never lands (it dies first); its commits are
    # whatever last_committed recovered — counted 0 here, kept for the
    # uninterrupted tags
    p = os.path.join(workdir, f"meta_{tag}.json")
    if not os.path.exists(p):
        return 0
    with open(p) as f:
        return int(json.load(f).get("ckpt_commits", 0))


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="strom_torch.faults.resume_harness")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("trainer", help="internal: one trainer process")
    tr.add_argument("--workdir", required=True)
    tr.add_argument("--shard", required=True)
    tr.add_argument("--tag", default="ref")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--steps", type=int, default=24)
    tr.add_argument("--batch", type=int, default=4)
    tr.add_argument("--record-tokens", type=int, default=64,
                    dest="record_tokens")
    tr.add_argument("--ckpt-every", type=int, default=4, dest="ckpt_every")
    tr.add_argument("--die-at", type=int, default=-1, dest="die_at")
    tr.add_argument("--die-signal", default="KILL", dest="die_signal",
                    choices=["KILL", "TERM"])
    tr.add_argument("--engine", default="python")
    tr.add_argument("--fault-plan", default="", dest="fault_plan")
    tr.add_argument("--cache-bytes", type=int, default=0, dest="cache_bytes")
    tr.add_argument("--depth", type=int, default=2)
    tr.add_argument("--resume", action="store_true")
    tr.add_argument("--warm-hints", action="store_true", dest="warm_hints")

    run = sub.add_parser("run", help="full kill→restart→verify cycle")
    run.add_argument("--workdir", required=True)
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--signal", default="KILL", choices=["KILL", "TERM"])
    run.add_argument("--engine", default="python")
    run.add_argument("--fault-plan", default="", dest="fault_plan")

    args = ap.parse_args(argv)
    if args.cmd == "trainer":
        return _trainer(args)
    out = run_kill_resume(args.workdir, seed=args.seed, sig=args.signal,
                          engine=args.engine, fault_plan=args.fault_plan)
    print(json.dumps(out))
    return 0 if out["resume_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
