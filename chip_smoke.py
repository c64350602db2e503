"""Run the PyTorch port's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. build    -- compile every CUDA source of strom_torch with nvcc (sm_90a).
2. kernels  -- each flash-attention kernel against its plain PyTorch version
               on the card, at the main path's shape and at ``small``'s,
               timed with CUDA events beside its bound and SDPA's time.
3. ssd2gpu  -- a seeded 1 GiB file delivered into device memory by
               memcpy_ssd2gpu: a 64 MiB unstreamed read, then the whole file
               streamed, sync and async; bytes checked exactly.
4. train    -- seeded packed-token shards through make_llama_pipeline into
               make_train_step(Llama-3-8B widths, 2 layers, attn="flash"),
               4 steps; every kernel must have launched during the steps.
               Then one more step under torch.profiler: device time by
               kernel group and the device's idle share.

Each phase prints its own lines. The line before the last is one JSON
object describing every kernel; the last line is the result,
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with an error and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import strom_torch
from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.formats.rawbin import write_token_shard
from strom_torch.models.llama import LlamaConfig, next_token_loss
from strom_torch.ops import build
from strom_torch.ops import flash_attention as fa
from strom_torch.parallel.train import init_train_state, make_train_step
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline
from strom_torch.pipelines.sampler import EpochShuffleSampler

GiB = 1 << 30
MiB = 1 << 20
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (name, file:line of the TPU kernel it replaces)
KERNELS = {
    "fa_fwd": "strom/ops/flash_attention.py:42",
    "fa_bwd_dkv": "strom/ops/flash_attention.py:158",
    "fa_bwd_dq": "strom/ops/flash_attention.py:204",
}
SOURCE = "strom_torch/csrc/flash_attention.cu"


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ build
def phase_build() -> None:
    t0 = time.perf_counter()
    libs = build.build_all()
    dt = time.perf_counter() - t0
    for name, path in libs.items():
        log = build.build_logs.get(name, "(cached)")
        say("build", source=name, lib=os.path.relpath(path),
            nvcc_s=f"{build.build_seconds.get(name, 0.0):.2f}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  " + line.strip())
    say("build", total_s=f"{dt:.2f}")


# ---------------------------------------------------------------- kernels
def _pairs(B: int, S: int, H: int, causal: bool) -> int:
    """(q row, kv row) pairs attention visits for these inputs."""
    return B * H * (S * (S + 1) // 2 if causal else S * S)


def _bound_ms(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol_frac: float) -> float:
    """|got - want| <= rtol*|want| + atol_frac*max|want|, elementwise."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    bad = err > rtol * want.abs() + atol_frac * scale
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol={rtol} "
            f"atol={atol_frac}*max|ref| (max err {err.max().item():.3e}, "
            f"max|ref| {scale:.3e})")
    return err.max().item()


def _inputs(B, S, H, KV, Dh, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda",  # noqa: E731
                                dtype=torch.float32).to(dtype)
    return mk(B, S, H, Dh), mk(B, S, KV, Dh), mk(B, S, KV, Dh), mk(B, S, H, Dh)


def check_kernels_f32() -> None:
    """Small f32 shapes, causal and not: the kernels against their plain
    versions at the tolerance of f32 sums taken in another order."""
    for (B, S, H, KV, Dh) in [(1, 256, 4, 2, 64), (2, 128, 4, 4, 128)]:
        for causal in (True, False):
            q, k, v, g = _inputs(B, S, H, KV, Dh, torch.float32, 1)
            out, lse = fa._flash_fwd_kernel(q, k, v, causal=causal)
            pout, plse = fa._flash_fwd_plain(q, k, v, causal=causal,
                                             block_q=64, block_k=64)
            delta = fa._delta(pout, g)
            grads = fa._flash_bwd_kernel(q, k, v, g, plse, delta, causal=causal)
            pgrads = fa._flash_bwd_plain(q, k, v, g, plse, delta, causal=causal,
                                         block_q=64, block_k=64)
            torch.cuda.synchronize()
            errs = [_close("out", out, pout, 1e-4, 1e-5),
                    _close("lse", lse, plse, 1e-5, 1e-6)]
            for n, a, b in zip(("dq", "dk", "dv"), grads, pgrads):
                errs.append(_close(n, a, b, 1e-4, 1e-5))
            say("kernels", check="f32", shape=(B, S, H, KV, Dh), causal=causal,
                max_abs_err=f"{max(errs):.2e}")


def phase_kernels() -> dict:
    """bf16 at the main path's and small's shapes. The plain versions run
    in f32 on the same bf16 inputs, so the only differences are the
    kernels' bf16 rounding of their outputs (relative 2^-9 = 2e-3) and the
    order of f32 sums: out, dq, dk and dv must agree within 1e-2 relative
    plus 1e-3 of the tensor's largest value; lse is f32 in both and must
    agree within 1e-3 absolute (values near log S ~ 8)."""
    check_kernels_f32()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    for label, (B, S, H, KV, Dh) in [("main", (2, 2048, 32, 8, 128)),
                                     ("small", (2, 2048, 12, 4, 64))]:
        dt = torch.bfloat16
        q, k, v, g = _inputs(B, S, H, KV, Dh, dt, 0)
        qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
        out, lse = fa._flash_fwd_kernel(q, k, v, causal=True)
        pout, plse = fa._flash_fwd_plain(qf, kf, vf, causal=True,
                                         block_q=128, block_k=128)
        delta = fa._delta(pout, gf)
        dq, dk, dv = fa._flash_bwd_kernel(q, k, v, g, plse, delta, causal=True)
        pdq, pdk, pdv = fa._flash_bwd_plain(qf, kf, vf, gf, plse, delta,
                                            causal=True, block_q=128,
                                            block_k=128)
        torch.cuda.synchronize()
        err_fwd = max(_close("out", out, pout, 1e-2, 1e-3),
                      _close("lse", lse, plse, 0.0, 1e-3 / max(
                          plse.abs().max().item(), 1e-6)))
        err_dkv = max(_close("dk", dk, pdk, 1e-2, 1e-3),
                      _close("dv", dv, pdv, 1e-2, 1e-3))
        err_dq = _close("dq", dq, pdq, 1e-2, 1e-3)

        n_iter = 10 if label == "main" else 5
        ms = {
            "fa_fwd": cuda_ms(lambda: fa._flash_fwd_kernel(q, k, v, causal=True),
                              n_iter),
            "fa_bwd_dkv": cuda_ms(lambda: fa._bwd_dkv_kernel(
                q, k, v, g, plse, delta, causal=True), n_iter),
            "fa_bwd_dq": cuda_ms(lambda: fa._bwd_dq_kernel(
                q, k, v, g, plse, delta, causal=True), n_iter),
        }
        plain_fwd = cuda_ms(lambda: fa._flash_fwd_plain(
            qf, kf, vf, causal=True, block_q=128, block_k=128), 2)
        plain_bwd = cuda_ms(lambda: fa._flash_bwd_plain(
            qf, kf, vf, gf, plse, delta, causal=True, block_q=128,
            block_k=128), 2)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True), n_iter)
        pairs = _pairs(B, S, H, True)
        e = q.element_size()
        qb, kvb, rowb = B * S * H * Dh * e, B * S * KV * Dh * e, B * H * S * 4
        work = {
            "fa_fwd": (qb + 2 * kvb + qb + rowb, 4 * Dh * pairs),
            "fa_bwd_dkv": (2 * qb + 2 * kvb + 2 * rowb + 2 * kvb, 8 * Dh * pairs),
            "fa_bwd_dq": (2 * qb + 2 * kvb + 2 * rowb + qb, 6 * Dh * pairs),
        }
        errs = {"fa_fwd": err_fwd, "fa_bwd_dkv": err_dkv, "fa_bwd_dq": err_dq}
        plain = {"fa_fwd": plain_fwd, "fa_bwd_dkv": plain_bwd,
                 "fa_bwd_dq": plain_bwd}
        for name in KERNELS:
            bound, by = _bound_ms(*work[name], dt)
            row = {"ms": ms[name], "plain_ms": plain[name], "bound_ms": bound,
                   "bound_by": by, "max_abs_err": errs[name],
                   "library_ms": sdpa if name == "fa_fwd" else None}
            say("kernels", kernel=name, shape=label,
                **{k_: (f"{v_:.4g}" if isinstance(v_, float) else v_)
                   for k_, v_ in row.items()})
            rows.setdefault(name, {})[label] = row
    say("kernels", note="plain_ms of the backward kernels is one plain "
        "backward computing dq, dk and dv together; library_ms is SDPA "
        "forward (flash backend), a yardstick the port never calls")
    return rows


# ---------------------------------------------------------------- ssd2gpu
def _write_file(path: str, data: np.ndarray) -> None:
    with open(path, "wb") as f:
        data.tofile(f)
        f.flush()
        os.fsync(f.fileno())
        # drop the written pages from the page cache, so the reads go to disk
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)


def _timed_delivery(label: str, call, want: torch.Tensor) -> float:
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if out.device.type != "cuda" or not torch.equal(out, want):
        raise AssertionError(f"ssd2gpu {label}: delivered bytes differ "
                             f"from the file")
    gbps = want.numel() / dt / 1e9
    say("ssd2gpu", read=label, bytes=want.numel(), s=f"{dt:.4f}",
        gbps=f"{gbps:.3f}", exact=True)
    return gbps


def phase_ssd2gpu(workdir: str) -> None:
    """A seeded 1 GiB file into device memory: 64 MiB unstreamed (twice:
    the first call also pins the pool's slab), then the whole file
    streamed, sync and async; every byte compared on the card. Then four
    more streamed reads, each paired with an engine-only read."""
    path = os.path.join(workdir, "ssd2gpu.bin")
    data = np.frombuffer(bytearray(np.random.default_rng(0).bytes(GiB)),
                         dtype=np.uint8)
    _write_file(path, data)
    want = torch.from_numpy(data).to("cuda")
    del data
    ctx = strom_torch.init(StromConfig.from_env())
    cfg = ctx.config
    say("ssd2gpu", engine=ctx.engine.stats()["engine"],
        o_direct=ctx.uses_o_direct(path), block_size=cfg.block_size,
        queue_depth=cfg.queue_depth,
        overlap_chunk_bytes=cfg.overlap_chunk_bytes,
        overlap_min_bytes=cfg.overlap_min_bytes)
    for label in ("64MiB-unstreamed-cold", "64MiB-unstreamed-warm"):
        _timed_delivery(label, lambda: strom_torch.memcpy_ssd2gpu(
            path, length=64 * MiB, device="cuda"), want[:64 * MiB])
    if strom_torch.stats()["streamed_transfers"] != 0:
        raise AssertionError("a 64 MiB read must not be streamed")
    _timed_delivery("1GiB-streamed-sync", lambda: strom_torch.memcpy_ssd2gpu(
        path, device="cuda"), want)
    _timed_delivery("1GiB-streamed-async", lambda: strom_torch.memcpy_wait(
        strom_torch.memcpy_ssd2gpu(path, device="cuda", async_=True)), want)
    st = strom_torch.stats()
    if st["streamed_transfers"] != 2:
        raise AssertionError(f"expected 2 streamed transfers, got {st}")
    say("ssd2gpu", stats=json.dumps(st, sort_keys=True))

    # The yardstick of a delivery: the engine alone reading the file into a
    # host slab (prefaulted, as the pool's slabs are). The disk's rate
    # drifts within a run, so the two arms alternate which goes first.
    slab = alloc_aligned(GiB, populate=True)
    fi = ctx.file_index(path)
    ratios = []
    for i in range(4):
        gbps = {}
        for arm in (("engine", "delivered") if i % 2 == 0
                    else ("delivered", "engine")):
            if arm == "delivered":
                gbps[arm] = _timed_delivery(
                    f"1GiB-streamed-pair{i}", lambda: strom_torch.memcpy_ssd2gpu(
                        path, device="cuda"), want)
                continue
            t0 = time.perf_counter()
            if ctx.engine.read_vectored([(fi, 0, 0, GiB)], slab) != GiB:
                raise AssertionError("engine-only read came up short")
            gbps[arm] = GiB / (time.perf_counter() - t0) / 1e9
        ratios.append(gbps["delivered"] / gbps["engine"])
        say("ssd2gpu", pair=i, first=("engine" if i % 2 == 0 else "delivered"),
            engine_only_gbps=f"{gbps['engine']:.3f}",
            delivered_gbps=f"{gbps['delivered']:.3f}",
            ratio=f"{ratios[-1]:.3f}")
    if not torch.equal(torch.from_numpy(slab).to("cuda"), want):
        raise AssertionError("engine-only read differs from the file")
    say("ssd2gpu", delivered_vs_engine_only_median=f"{statistics.median(ratios):.3f}",
        pairs=len(ratios))
    # the other half of a delivery: one host-to-device copy of 1 GiB out of
    # pinned memory
    pinned = torch.empty(GiB, dtype=torch.uint8, pin_memory=True)
    h2d_ms = cuda_ms(lambda: want.copy_(pinned, non_blocking=True), 3)
    say("ssd2gpu", read="1GiB-pinned-host-to-device-copy", ms=f"{h2d_ms:.3f}",
        gbps=f"{GiB / h2d_ms / 1e6:.3f}")
    strom_torch.close()
    os.unlink(path)


# ------------------------------------------------------------------ train
def phase_train(workdir: str) -> dict[str, int]:
    """Packed-token shards → make_llama_pipeline → make_train_step at
    Llama-3-8B widths, 2 layers, flash attention; 4 steps. Returns each
    kernel's launches during the steps."""
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    B, seq_len, steps, records = 2, 2047, 4, 16
    rng = np.random.default_rng(1)
    shards = [rng.integers(0, cfg.vocab, (records, seq_len + 1), dtype=np.int32)
              for _ in range(2)]
    paths = []
    for i, toks in enumerate(shards):
        paths.append(os.path.join(workdir, f"tokens{i}.bin"))
        write_token_shard(paths[-1], toks)
    all_records = torch.from_numpy(np.concatenate(shards)).to("cuda")

    ctx = strom_torch.init(StromConfig.from_env())
    pipe = make_llama_pipeline(ctx, paths, batch=B, seq_len=seq_len,
                               device="cuda", seed=0)
    order = iter(EpochShuffleSampler(2 * records, B, seed=0))
    state = init_train_state(cfg, device="cuda", seed=0)
    step = make_train_step(cfg, attn="flash", device="cuda")
    say("train", config="llama3_8b", n_layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", d_ff=cfg.d_ff, vocab=cfg.vocab,
        params=sum(p.numel() for p in state.model.parameters()), batch=B,
        tokens_per_row=seq_len + 1)

    def next_batch() -> torch.Tensor:
        batch = next(pipe)
        want = all_records[torch.from_numpy(next(order)).to("cuda")]
        if batch.shape != (B, seq_len + 1) or not torch.equal(batch, want):
            raise AssertionError("pipeline batch differs from the sampler's "
                                 "records")
        return batch

    # reference on the first batch: flash against the dense attention op
    first = next_batch()
    with torch.no_grad():
        flash = next_token_loss(state.model, first,
                                attn_fn=fa.make_flash_attention()).item()
        dense = next_token_loss(state.model, first).item()
    # bf16 activations: attention outputs differ by bf16 rounding (2^-9
    # relative) between the two paths; the mean loss over 4094 tokens
    # moves far less than 0.05
    if not (math.isfinite(flash) and abs(flash - dense) < 0.05):
        raise AssertionError(f"flash loss {flash} vs dense loss {dense}")
    say("train", check="first batch, flash vs dense loss", flash=f"{flash:.5f}",
        dense=f"{dense:.5f}", abs_diff=f"{abs(flash - dense):.2e}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times = []
    for i in range(steps):
        batch = first if i == 0 else next_batch()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"step {i}: loss {loss}, grad_norm {norm}")
        say("train", step=i, loss=f"{loss:.5f}", grad_norm=f"{norm:.5f}",
            ms=f"{times[-1] * 1e3:.1f}")
    launches = dict(fa.LAUNCHES)
    steady = sum(times[1:]) / (steps - 1)
    say("train", step_ms_first=f"{times[0] * 1e3:.1f}",
        step_ms_steady=f"{steady * 1e3:.1f}",
        tokens_per_s=f"{B * (seq_len + 1) / steady:.0f}",
        max_memory_allocated_gib=f"{torch.cuda.max_memory_allocated() / GiB:.2f}",
        data_stall_steps=pipe.data_stall_steps,
        launches=json.dumps(launches, sort_keys=True))
    profile_step(step, state, next_batch())
    pipe.close()
    strom_torch.close()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in the train "
                                 f"steps")
    return launches


def _kernel_group(name: str) -> str:
    for kernel in KERNELS:
        if f"{kernel}_kernel" in name:
            return kernel
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    return "other"


def profile_step(step, state, batch) -> None:
    """One more step, after the timed ones, under torch.profiler: device
    time by kernel group and the device's busy share of the step's wall
    time (the union of device intervals over the host clock)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)[1]["loss"].item()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels and copies only: a range annotation (the optimizer's
    # step, say) is mirrored on the device timeline over its kernels
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    if not spans:
        say("profile", device_time="not measured",
            note="the profiler recorded no device events")
        return
    groups: dict[str, float] = {}
    by_name: dict[str, list[float]] = {}
    busy, reach = 0.0, -math.inf
    for start, end, name in sorted(spans):
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + (end - start)
        n_us = by_name.setdefault(name, [0, 0.0])
        n_us[0] += 1
        n_us[1] += end - start
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    say("profile", step_ms=f"{wall_us / 1e3:.1f}",
        device_busy_ms=f"{busy / 1e3:.1f}",
        device_idle_share=f"{1 - busy / wall_us:.3f}",
        **{f"{g}_ms": f"{us / 1e3:.2f}" for g, us in
           sorted(groups.items(), key=lambda kv: -kv[1])})
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        say("profile", group=_kernel_group(name), calls=n, ms=f"{us / 1e3:.2f}",
            kernel=name[:110].replace(" ", "_"))


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ".chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    try:
        phase_build()
        rows = phase_kernels()
        phase_ssd2gpu(workdir)
        launches = phase_train(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces, "launches": launches[name],
                **{k: rows[name]["main"][k] for k in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for name, replaces in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
