"""Run the PyTorch port's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. build    -- compile every CUDA source of strom_torch with nvcc (sm_90a);
               print each kernel instantiation's ptxas registers and
               spills; a spill in either source fails the phase.
2. kernels  -- each flash-attention kernel against its plain PyTorch version
               on the card: f32 and bf16 at small shapes (causal and not, S
               a multiple of 64 but not of 128, head dims 32, 48 and 96 that
               the wrappers zero-pad, S 63 and 96 off the 64-row tile), then
               bf16 at the main path's shape and at ``small``'s; bf16 dq
               must round dS as
               the JAX package does (share of elements that differ from
               the bf16 plain version). Each kernel is timed with CUDA
               events, median of 5 runs with min and max, beside its
               bound and SDPA's forward or backward time. Then head dims
               160, 192, 256, 320 and 512 (zero-padded to a multiple of
               128; bf16 at 256 runs the three wgmma kernels, dq with its
               dS rounding checked, every other wide head the scalar
               kernels) at S 63 and 192, and the three kernels timed at
               Gemma-2-9B's attention shape (B 2, S 2048, H 16, KV 8,
               Dh 256, bf16, causal): ms, TFLOP/s, bound and SDPA's time,
               and the backward pair over SDPA's backward; then the scalar
               kernels' bf16 route at that shape with heads of 512 (the
               "_dh512" rows of the JSON). Last, the f32 kernels (4x8 and
               8x8 register tiles fed by float4 reads of swizzled tiles
               and a 2-stage cp.async ring; the forward over 128-row q
               tiles, a wide head's chunks in one cluster) at the main
               shape beside SDPA in f32 with TF32 off (the "_f32" rows; no
               f32 or Dh-512 call is on the main path). Before the timed
               shapes, each kernel fed bf16 inputs that start 4 bytes into
               their storage must equal its result on aligned copies, bit
               for bit.
2b. wide_path -- flash_attention, forward and backward, at that shape:
               the wide kernels' launches (the "_wide" rows of the JSON),
               counted per kernel, library and dtype: each row's kernel
               must have run from the source the row names (all three the
               wgmma kernels of flash_attention_sm90.cu), and from no
               other.
3. ssd2gpu  -- the [engine] line (io_uring available or why not, the
               engine engine="auto" chose, the native library's build time);
               then a seeded 1 GiB file delivered into device memory by
               memcpy_ssd2gpu under engine="auto": a 64 MiB unstreamed read,
               then the whole file streamed, sync and async; bytes checked
               exactly; the engine's READ_FIXED share and routes. Then
               alternating rounds of three arms on the cold file: the
               python engine alone, the io_uring engine alone (skipped,
               with the errno, where the kernel refuses a ring) and a
               delivery, each with GB/s and host CPU seconds per GiB. The
               [check] line (check_file: tier, filesystem, extents,
               cached_frac); the [ssd2host] rounds, memcpy_ssd2host against
               the context's engine alone on the cold file, alternating,
               exact, with vs_raw; one more memcpy_ssd2host of the file
               warm in the page cache, with the engine's cached_bytes.
               [sched]: 2 rounds of the 1 GiB streamed delivery through a
               context with the multi-tenant scheduler (the default) and
               one with sched_enabled=False, beside the engine alone, in
               alternating order: each arm's GB/s, both deliveries' ratio
               to the engine alone, exact bytes, and the scheduler's
               stats(), whose granted bytes must equal the bytes delivered
               through it. Last, the file striped RAID0 over 4 member
               files, checked with check_file, and delivered through a
               striped alias under 4 rings and under 1, exact.
4. train    -- seeded packed-token shards through make_llama_pipeline into
               make_train_step(Llama-3-8B widths, 2 layers, attn="flash"),
               which on the card runs each step as one captured CUDA
               graph: 4 counted steps (the warm-up, the capture, two
               replays); every kernel must have launched during them,
               from the source its row names (the bf16 wgmma kernels) and
               from no other; the f32 rows' launches are read there too.
               4 more replays timed; captured=true, the graphs, the
               warm-up's, the capture's and the steady ms. Then one more
               replay under torch.profiler: device time by kernel group
               and the device's idle share. Last, 4 steps of the captured
               step and 4 of its eager body on fresh states from one seed
               and the same batches: losses, grad norms and sampled
               parameters bit-equal.
4b. ckpt    -- the write path and checkpoints. [write]: 1 GiB of seeded
               bytes through ctx.pwrite (the engine's write path, fsync)
               and through os.pwrite plus fsync, alternating, 2 rounds:
               GB/s, host CPU s per GiB, the engine's direct, buffered and
               unaligned write counts, read back exact. [ckpt]: phase 4's
               configuration (token shards written through ctx.pwrite): 3
               captured steps, then save_checkpoint of train_state_tree
               (about 8.9 GB: bf16 parameters and AdamW moments, the step
               tensors, the lr, the scheduler, the step) with its
               StepToken (the loader's state): bytes, leaves, MB/s with
               the commit, the device-to-host share; 3 more steps of the
               uninterrupted run; restore_checkpoint onto a fresh state on
               the card (load_train_state) and a fresh pipeline from the
               token, every leaf equal to the saved one (ckpt_roundtrip_ok)
               and restore MB/s; 3 resumed steps on a new captured step,
               whose losses, grad norms and final leaves must equal the
               uninterrupted run's bit for bit (resume_ok), the flash
               kernels' launches counted over them as in phase 4;
               save_pickle of the same host leaves (MB/s, over the save);
               last, two AsyncCheckpointer.save calls (the first makes its
               pinned snapshot arena, the second reuses it), each followed
               at once by 2 replays while the commit drains: the caller's
               stall against the blocking save, and the checkpoint equal
               to the state at the save, leaf by leaf. Prints the disk's
               free space first and deletes each artefact once read back.
5. stream   -- StromContext.stream_segments under engine="auto": 2048
               seeded, scattered 150,528-byte records of phase 3's file
               gathered into a pinned slab; the completed ranges must tile
               the slab exactly once and the bytes, copied to the card,
               equal the file's. GB/s, the engine's in-flight peak and the
               poll calls. Then a second gather closed mid-flight, and a
               third on the same context that must be exact.
6. resnet   -- a seeded predecoded shard (2048 records of 224x224x3 and
               labels, written in the format, no decoder needed) through
               make_predecoded_vision_pipeline(batch=128): the first batch
               must equal the sampler's records byte for byte, labels too;
               the loader alone, images/s over 8 batches; then ResNet-50 at
               full width (bf16) under make_resnet_sgd_step, captured:
               the warm-up and the capture, then 8 timed replays (finite
               loss and grad norm), one more under torch.profiler; then 3
               captured and 3 eager steps on fresh models, bit-equal.
               Phase 7's arms step the same captured step.
7. resnet_jpeg -- the [decode] line (native libjpeg-turbo build, cv2, PIL).
               Where an encoder and a resize exist (cv2 or PIL): a seeded
               WebDataset tar of 512 448x448 JPEGs (quality 90) through
               make_imagenet_resnet_pipeline(batch=128), streamed and with
               stream_intra_batch=False: 4 batches each, bit-identical, and
               stream_samples_early > 0; then 4 ResNet-50 steps fed by the
               streamed pipeline. Elsewhere the phase prints
               skipped=<what is missing>: a host library that is absent.
   7b. auto_depth -- that pipeline feeding ResNet-50 at fixed prefetch
               depth 2, then with prefetch_auto: 16 timed steps each, the
               depth trajectory (start, max, grows, shrinks) and stalls.
   7c. cache -- phase 6's shard with hot_cache_bytes 512 MiB and
               readahead_window_batches 4, three epochs, three passes on
               fresh contexts: loader images/s, cache, engine and readahead
               bytes per epoch; every batch equal to the uncached
               pipeline's; the third epoch served from the cache
               (second-touch admission); each epoch's median, min and max
               images/s over the passes.
   7d. decoded_cache -- the JPEG tar at full-resolution decode, uncached
               and then with hot_cache_bytes 1 GiB and decode_cache on
               (three passes on fresh contexts): four epochs each, the
               third feeding ResNet-50 steps timed in one loop in both
               arms, the others the loader alone; decoded-cache hits and
               plan-time hits per epoch; every batch equal to the uncached
               pipeline's; each epoch's images/s over the passes.
   7e. spill -- the NVMe spill tier under the hot cache. arm=pread: the
               reference's spill epoch pair at 1 GiB (a seeded int32 token
               shard, values below 2^15, written through
               write_token_shard(ctx, ...); hot_cache_bytes 128 MiB,
               admission "always", spill_bytes 2 GiB in the work
               directory; 32 records of 4 KiB a pread; two epochs), with
               spill_compress off and then on: per epoch the SPILL_FIELDS,
               cache_miss_bytes, engine bytes, MB/s, the compression ratio
               and the codec's name; every read equal to the shard's bytes
               and no source miss in epoch 2. arm=resnet: phase 6's shard
               into a fresh ResNet-50's captured step for 3 epochs (one
               pipeline an epoch, prefetch depth 1), uncached and then
               with hot_cache_bytes 64 MiB, "always" and a 1 GiB spill
               file: batches and losses bit-equal to the uncached run's,
               images/s and the spill fields per epoch, no source miss in
               epochs 2 and 3.
8. vit      -- BASELINE config #3. Phase 6's predecoded shard striped RAID0
               over 4 member files in 512 KiB chunks
               (stage_striped_predecoded) through
               make_predecoded_vision_pipeline(batch=64): the first batch
               byte-exact, the loader alone; then ViT-B/16 at full width
               (bf16) under make_vit_sgd_step, captured: the warm-up and
               the capture, then 8 timed replays (finite loss and grad
               norm), one more under torch.profiler; then 3 captured and
               3 eager steps on fresh models, bit-equal.
               Where phase 7 made its JPEG tar: the tar striped over 4
               members the same way through make_vit_wds_pipeline(batch=64),
               the loader alone and 4 ViT steps; elsewhere skipped=.
9. parquet  -- BASELINE config #5. Four seeded shards written by the port's
               write_parquet (2,097,152 rows each in row groups of 524,288:
               seq int64, a global arange; value and f0-f15 float32;
               payload int64; PLAIN, uncompressed, no dictionary: 704 MB).
               pyarrow= (its version, or absent); where present, pyarrow
               reads a shard equal to the written arrays and the port reads
               a pyarrow-written PLAIN file equal to pyarrow's values. The
               narrow arm (parquet_count_where over value, map_fn on the
               card) and the wide arm (parquet_scan_aggregate over value
               and f0-f15: hits and the sum of the 16 column sums), each
               cold in 2 passes alternating with a bare engine gather of the
               same extents: rows/s, selected GB/s, the gather's GB/s,
               vs_disk, host CPU s per GiB, PLAIN and pyarrow bytes (every
               byte PLAIN), prefetch stalls, the prefetch threads' read,
               pack and put microseconds; counts exact against numpy, fsum
               within a pairwise-sum bound. Where the wide scan's time
               goes: its gathers alone, into fresh buffers and into one
               reused one, and the scan at prefetch depth 1 and 4. One
               wide scan under torch.profiler: device busy ms and idle
               share. The pushdown A/B at selectivity 0.25 over seq <
               cutoff (groups refuted, skipped bytes > 0, equal hits, both
               arms' rows/s); shard 0
               striped over 4 members behind an alias, narrow and wide
               equal to the plain shard's bit for bit; where phase 7 made
               its tar, the wds pipeline with an OpGraph (filter, project,
               normalize, cast) fused and streamed against unfused, bit-equal.
10. multitenant -- the reference's bench_multitenant at full width on one
               context with three registered tenants: llama (training:
               phase 4's shards into a fresh captured flash step, 2 warm-up
               and capture steps, then 16 timed), vis0 (training: phase
               6's shard through the predecoded loader alone, 48 batches
               of 128) and pq (interactive: phase 9's narrow scan, 12
               times). Each solo, then the three at once on threads (after
               Llama's capture), then at once with sched_enabled=False. Per
               tenant the SCHED_FIELDS (items/s, vs_solo, queue-wait p50
               and p99, granted ops and bytes, throttle waits, the engine's
               per-op p99), mt_vs_solo_mean, Llama's timed data stalls, and
               pq's p99 queue wait beside one slice's time at 2 GB/s. The
               concurrent Llama losses must equal solo's bit for bit (both
               modes), every pq count is exact, and the Llama tenant must
               launch the three sm90 kernels.

Each phase prints its own lines. The line before the last is one JSON
object describing every kernel; the last line is the result,
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with an error and prints no result.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import math
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import strom_torch
from strom_torch.config import StromConfig
from strom_torch._core import build as core_build
from strom_torch.ckpt import (AsyncCheckpointer, load_manifest, load_pickle,
                              restore_checkpoint, save_checkpoint,
                              save_pickle)
from strom_torch.ckpt.checkpoint import (_host_leaves, tree_flatten,
                                         tree_unflatten)
from strom_torch.ckpt.jobstate import TOKEN_KEY, StepToken
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.core import StripedFile, StromContext
from strom_torch.delivery.extents import Extent, ExtentList
from strom_torch.delivery.shard import Segment
from strom_torch.engine import make_engine
from strom_torch.engine import uring_engine
from strom_torch.engine.python_engine import PythonEngine
from strom_torch.engine.raid0 import stripe_file
from strom_torch.formats import jpeg
from strom_torch.formats.parquet import (ParquetShard, pyarrow_version,
                                         write_parquet)
from strom_torch.formats.predecoded import (LABELS_SUFFIX, META_SUFFIX,
                                            PredecodedShardSet,
                                            stage_striped_predecoded)
from strom_torch.delivery.spill import SPILL_FIELDS
from strom_torch.formats.rawbin import TokenShardSet, write_token_shard
from strom_torch.models.llama import LlamaConfig, next_token_loss
from strom_torch.models.resnet import ResNet, ResNetConfig
from strom_torch.models.vit import ViT, ViTConfig
from strom_torch.ops import build
from strom_torch.ops import flash_attention as fa
from strom_torch.ops.pushdown import PUSHDOWN_FIELDS, OpGraph, col
from strom_torch.parallel.train import (init_train_state, load_train_state,
                                        make_resnet_sgd_step, make_train_step,
                                        make_vit_sgd_step, train_state_tree)
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline
from strom_torch.pipelines.parquet_scan import (parquet_count_where,
                                                parquet_scan_aggregate)
from strom_torch.pipelines.sampler import EpochShuffleSampler, SamplerState
from strom_torch.utils.codec import default_codec
from strom_torch.utils.stats import percentile_from_buckets
from strom_torch.pipelines.vision import (make_imagenet_resnet_pipeline,
                                          make_predecoded_vision_pipeline,
                                          make_vit_wds_pipeline,
                                          make_wds_vision_pipeline)

GiB = 1 << 30
MiB = 1 << 20
IMAGE = 224
RECORD = IMAGE * IMAGE * 3          # one 224x224x3 uint8 image: 150,528 B
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SM90 = "strom_torch/csrc/flash_attention_sm90.cu"
SCALAR = "strom_torch/csrc/flash_attention.cu"
LIBRARY = {SM90: "sm90", SCALAR: "scalar"}   # fa.kernel_route's names
# name -> the TPU kernel it replaces (file:line), the source and design of
# the kernel the main path (bf16) runs, and the device symbols of every
# instantiation (the f32 ones of flash_attention.cu included) for the
# profile's grouping; each table's "variant" is its fa.VARIANT_LAUNCHES key
KERNELS = {
    "fa_fwd": {"replaces": "strom/ops/flash_attention.py:42", "source": SM90,
               "design": "wgmma, 128-row kv tiles, no producer warpgroup",
               "symbols": ("fa_fwd_wgmma_kernel", "fa_fwd_kernel")},
    "fa_bwd_dkv": {"replaces": "strom/ops/flash_attention.py:158",
                   "source": SM90, "design": "wgmma, producer warpgroup",
                   "symbols": ("fa_bwd_dkv_wgmma_kernel", "fa_bwd_dkv_kernel")},
    "fa_bwd_dq": {"replaces": "strom/ops/flash_attention.py:204",
                  "source": SM90, "design": "wgmma, producer warpgroup",
                  "symbols": ("fa_bwd_dq_wgmma_kernel", "fa_bwd_dq_kernel")},
}
for _name, _info in KERNELS.items():
    _info.update(counter=_name, variant=fa.variant(_name, "sm90",
                                                   torch.bfloat16))
# the scalar kernels of flash_attention.cu, by kernel
SCALAR_DESIGNS = {
    "fa_fwd": "f32 FMA, 128-row q tiles over 64-row k/v tiles, 4x8 score "
              "and 8x8 P.V register tiles, float4 reads of XOR-swizzled "
              "tiles, 2-stage cp.async ring of k/v tiles; a wider head: a "
              "cluster of one CTA a 128-column chunk summing partial scores "
              "through distributed shared memory (scores computed once)",
    "fa_bwd_dkv": "f32 FMA, two 128-thread groups (S^T | dP^T, then dV | "
                  "dK; P, dS by all threads), 4x8 and 8x8 register tiles, "
                  "float4 reads of XOR-swizzled tiles, 2-stage cp.async "
                  "ring of q/dO tiles",
    "fa_bwd_dq": "f32 FMA, two 128-thread groups (S | dP, then dq's two "
                 "column halves; dS by all threads), 4x8 register tiles, "
                 "float4 reads of XOR-swizzled tiles, 2-stage cp.async "
                 "ring of k/v tiles",
}
# the kernels bf16 heads of 129-256 run (padded to 256, counted under the
# same names): the three wgmma kernels at width 256; their path is
# flash_attention at Gemma-2-9B's attention shape (phase 2b), which checks
# each source against the library its launches were counted under (a wide
# dQ launched from the scalar library fails the run)
WIDE_KERNELS = {
    f"{name}_wide": {"counter": name, "replaces": KERNELS[name]["replaces"],
                     "source": source, "design": design,
                     "variant": fa.variant(name, LIBRARY[source],
                                           torch.bfloat16)}
    for name, source, design in (
        ("fa_fwd", SM90, "wgmma, 64-row kv tiles, m64n256 P.V, no producer "
         "warpgroup"),
        ("fa_bwd_dkv", SM90, "wgmma, 2-stage ring, one P^T buffer, no "
         "producer warpgroup"),
        ("fa_bwd_dq", SM90, "wgmma, 256 threads (no producer warpgroup), "
         "K/V slot ring: K double-buffered, V in one slot"))}
# the scalar kernels (flash_attention.cu): f32 at every head, timed at the
# main shape, and bf16 above 256, timed at Gemma-2-9B's batch and heads
# with Dh 512; no such call is on the main path, which runs bf16 at 128
F32_KERNELS = {
    f"{name}_f32": {"counter": name, "replaces": info["replaces"],
                    "source": SCALAR, "design": SCALAR_DESIGNS[name],
                    "variant": fa.variant(name, "scalar", torch.float32)}
    for name, info in KERNELS.items()}
DH512_KERNELS = {
    f"{name}_dh512": {"counter": name, "replaces": info["replaces"],
                      "source": SCALAR, "design": SCALAR_DESIGNS[name]
                      + "; bf16 converted to f32 when staged",
                      "variant": fa.variant(name, "scalar", torch.bfloat16)}
    for name, info in KERNELS.items()}
# B, S, H, KV, Dh: Gemma-2-9B's attention (16 query heads, 8 kv heads,
# head 256) at the train batch of phase 4; and the same with heads of 512
GEMMA2_9B = (2, 2048, 16, 8, 256)
GEMMA2_9B_DH512 = GEMMA2_9B[:4] + (512,)


def check_variants(table: dict, variants: dict[str, int],
                   path: str) -> dict[str, int]:
    """Each row of *table*'s launches on *path*, given *variants*, the
    fa.VARIANT_LAUNCHES of that run (set to 0 just before it, read just
    after): the launches of the row's variant (its kernel from the row's
    source, in its dtype). Fails where a row's kernel never launched, or
    launched as another variant as well (another library or dtype than
    the row names)."""
    launched = {v: n for v, n in variants.items() if n}
    for name, info in table.items():
        if launched.get(info["variant"], 0) <= 0:
            raise AssertionError(f"kernel {name} ({info['variant']}) never "
                                 f"launched on the {path}; launched: "
                                 f"{launched}")
        other = [v for v in launched if v != info["variant"]
                 and v.startswith(info["counter"] + "@")]
        if other:
            raise AssertionError(f"kernel {name}: the row names "
                                 f"{info['variant']}, the {path} also "
                                 f"launched {other}")
    return {name: launched[info["variant"]] for name, info in table.items()}


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


REPEATS = 5


def cuda_ms_spread(fn, iters: int) -> tuple[float, float, float]:
    """(median, min, max) of REPEATS runs of cuda_ms(fn, iters)."""
    runs = [cuda_ms(fn, iters) for _ in range(REPEATS)]
    return statistics.median(runs), min(runs), max(runs)


# ------------------------------------------------------------------ build
def ptxas_report(log: str) -> list[dict]:
    """One entry per kernel instantiation in nvcc's ``-Xptxas -v`` output:
    its name with template arguments (``fa_bwd_dq_kernel<f,128>``,
    ``fa_fwd_wgmma_kernel<256>``, ``fa_fwd_kernel<bf16,128,true>``: the
    forward's last argument says whether it runs in clusters),
    registers and spill stores."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
        if entry:
            m = re.search(r"(fa_\w+?_kernel)I(f|13__nv_bfloat16)?Li(\d+)E"
                          r"(?:Lb([01])E)?", entry[1])
            dtype = {"f": "f,", "13__nv_bfloat16": "bf16,"}.get(m and m[2], "")
            flag = {"0": ",false", "1": ",true"}.get(m and m[4], "")
            name = f"{m[1]}<{dtype}{m[3]}{flag}>" if m else entry[1]
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores and name:
            out.append({"kernel": name, "spill_stores": int(stores[1])})
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out and out[-1]["kernel"] == name:
            out[-1]["registers"] = int(regs[1])
    return out


def phase_build() -> None:
    """Build both sources; print each kernel instantiation's registers and
    spills; fail on any spill (8 x 8 register tiles beside the score tiles
    are where the scalar backward kernels would start to spill)."""
    t0 = time.perf_counter()
    libs = build.build_all()
    dt = time.perf_counter() - t0
    spilled = []
    for name, path in libs.items():
        log = build.build_logs.get(name, "(cached)")
        say("build", source=name, lib=os.path.relpath(path),
            nvcc_s=f"{build.build_seconds.get(name, 0.0):.2f}")
        for line in log.splitlines():
            if "error" in line or "C75" in line:
                print("  " + line.strip())
        for entry in ptxas_report(log):
            say("build", **entry)
            if entry["spill_stores"]:
                spilled.append(f"{name}: {entry}")
    say("build", total_s=f"{dt:.2f}")
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")


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


def _check_against_plain(label, kernel_out, q, k, v, g, lse, delta, causal,
                         block, tol) -> dict[str, float]:
    """The kernels' (out, lse, dq, dk, dv) against the plain versions run on
    (q, k, v, g); tol = (rtol, atol as a fraction of max|ref|, lse atol).
    Returns the largest difference by kernel."""
    rtol, frac, lse_atol = tol
    pout, plse = fa._flash_fwd_plain(q, k, v, causal=causal, block_q=block,
                                     block_k=block)
    pdq, pdk, pdv = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=causal,
                                        block_q=block, block_k=block)
    out, klse, dq, dk, dv = kernel_out
    lse_err = _close(f"{label} lse", klse, plse, 0.0, lse_atol / max(
        plse.abs().max().item(), 1e-6))
    return {"fa_fwd": max(_close(f"{label} out", out, pout, rtol, frac), lse_err),
            "fa_bwd_dkv": max(_close(f"{label} dk", dk, pdk, rtol, frac),
                              _close(f"{label} dv", dv, pdv, rtol, frac)),
            "fa_bwd_dq": _close(f"{label} dq", dq, pdq, rtol, frac)}


def _check_dq_rounding(label, dq, q, k, v, g, lse, delta, causal, block):
    """bf16 dq against the bf16 plain version, which rounds dS to bf16
    before dS·K as the JAX package does (strom/ops/flash_attention.py:230):
    under 5 % of the elements may differ (f32 sums in another order that
    cross a bf16 rounding). The plain version with dS kept in f32 (fed k in
    f32) differs in some 40 %; it must differ in over 30 %, which shows the
    share tells the two rounding points apart."""
    plain = fa._flash_bwd_plain(q, k, v, g, lse, delta, causal=causal,
                                block_q=block, block_k=block)[0]
    f32_ds = fa._flash_bwd_plain(q, k.float(), v, g, lse, delta,
                                 causal=causal, block_q=block,
                                 block_k=block)[0]
    share = (dq != plain).float().mean().item()
    share_f32_ds = (f32_ds != plain).float().mean().item()
    say("kernels", check=f"{label} dq rounds dS to bf16",
        differ_share=f"{share:.5f}", f32_ds_differ_share=f"{share_f32_ds:.4f}")
    if not (share < 0.05 and share_f32_ds > 0.30):
        raise AssertionError(
            f"{label}: dq differs from the bf16 plain version in {share:.4f} "
            f"of its elements (limit 0.05); dS kept in f32 in "
            f"{share_f32_ds:.4f} (must exceed 0.30)")


# Tolerances (rtol, atol as a fraction of max|ref|, lse atol), by comparison:
# - f32 kernels against the f32 plain version: f32 sums in another order;
F32_TOL = (1e-4, 1e-5, 1e-3)
# - bf16 kernels against the plain version in f32 on the same bf16 inputs:
#   the kernels round their outputs to bf16 (2^-9 relative), and, as the JAX
#   package does, P before P.V and dV and dS before dK and dQ; an element
#   that cancels in a sum of such rounded terms over up to S rows can differ
#   by a few 2^-9 of the largest value, hence 5e-3 of it;
BF16_VS_F32_TOL = (1e-2, 5e-3, 1e-3)
# - bf16 kernels against the plain version in bf16, which rounds at the same
#   points as the kernels and the JAX package: the f32 sums before the last
#   rounding differ only in order, so an output may land one bf16 ulp away
#   (8e-3 relative), plus 2e-3 of the largest value for elements that
#   cancel; lse is f32 in both.
BF16_TOL = (8e-3, 2e-3, 2e-5)


def _run_kernels(q, k, v, g, causal):
    """Forward, then both backward kernels with the forward's lse and Δ."""
    out, lse = fa._flash_fwd_kernel(q, k, v, causal=causal)
    delta = fa._delta(out, g)
    dq, dk, dv = fa._flash_bwd_kernel(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    return (out, lse, dq, dk, dv), lse, delta


# heads wider than 128 (zero-padded to 256, 384, 512 or 640; bf16 at 256 runs
# the three wgmma kernels; 640 is a forward cluster of 5 CTAs), S a
# multiple of 64 and S off the 64-row tile
WIDE_SHAPES = [(1, S, 4, 2, Dh) for Dh in (160, 192, 256, 320, 512, 640)
               for S in (63, 192)]

# small shapes: (B, S, H, KV, Dh)
SMALL_SHAPES = [(1, 256, 4, 2, 64), (2, 128, 4, 4, 128),
                # S a multiple of 64 but not of the 128-row q tile
                (1, 192, 4, 2, 128),
                # head dims the wrappers zero-pad to 64 or 128, S off the
                # kernels' 64-row tile (LlamaConfig.tiny's head dim is 32)
                (2, 128, 4, 2, 32), (1, 63, 4, 2, 32), (1, 96, 4, 2, 48),
                (2, 192, 4, 2, 32), (1, 96, 4, 2, 96)]


def check_kernels_small(shapes=SMALL_SHAPES) -> None:
    """*shapes*, causal and not. f32 inputs run the scalar kernels, bf16
    the ones fa.kernel_route names (heads above 128: the scalar kernels
    but the three wgmma kernels at width 256); bf16 dq must round dS as
    the JAX package does. The plain versions take one block of S rows
    where 64 does not divide S, as the reference requires."""
    for (B, S, H, KV, Dh) in shapes:
        block = S if S % 64 else 64
        for causal in (True, False):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v, g = _inputs(B, S, H, KV, Dh, dt, 1)
                res, lse, delta = _run_kernels(q, k, v, g, causal)
                if res[0].shape != q.shape or res[2].shape != q.shape \
                        or res[3].shape != k.shape:
                    raise AssertionError(f"{(B, S, H, KV, Dh)}: output shapes "
                                         f"{[tuple(t.shape) for t in res]}")
                f32 = [t.float() for t in (q, k, v, g)]
                if dt == torch.float32:
                    errs = _check_against_plain("f32", res, *f32, lse, delta,
                                                causal, block, F32_TOL)
                else:
                    _check_against_plain("bf16 vs f32 plain", res, *f32, lse,
                                         delta, causal, block, BF16_VS_F32_TOL)
                    errs = _check_against_plain("bf16", res, q, k, v, g, lse,
                                                delta, causal, block, BF16_TOL)
                    _check_dq_rounding(f"bf16 {(B, S, H, KV, Dh)} causal="
                                       f"{causal}", res[2], q, k, v, g, lse,
                                       delta, causal, block)
                say("kernels", check=str(dt).split(".")[-1],
                    shape=(B, S, H, KV, Dh), causal=causal,
                    max_abs_err=f"{max(errs.values()):.2e}")


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of *t* that starts 4 bytes into its storage."""
    skip = 4 // t.element_size()
    flat = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)[skip:]
    return flat.view(t.shape).copy_(t)


def check_unaligned(shape=(1, 128, 4, 2, 128)) -> None:
    """Each kernel on bf16 inputs at Dh 128 (the wgmma kernels, which read
    through TMA maps and bulk copies) that start 4 bytes into their
    storage, lse and Δ too: the wrappers copy them to aligned memory
    first, so out, lse, dq, dk and dv equal the results on aligned
    copies, bit for bit."""
    q, k, v, g = _inputs(*shape, torch.bfloat16, 5)
    want, lse, delta = _run_kernels(q, k, v, g, True)
    sq, sk, sv, sg, slse, sdelta = (_shifted(t)
                                    for t in (q, k, v, g, lse, delta))
    if any(t.data_ptr() % 16 != 4 for t in (sq, sk, sv, sg, slse, sdelta)):
        raise AssertionError("unaligned check: the views are not 4 bytes off")
    out, flse = fa._flash_fwd_kernel(sq, sk, sv, causal=True)
    dk, dv = fa._bwd_dkv_kernel(sq, sk, sv, sg, slse, sdelta, causal=True)
    dq = fa._bwd_dq_kernel(sq, sk, sv, sg, slse, sdelta, causal=True)
    torch.cuda.synchronize()
    differ = [name for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                                         want, (out, flse, dq, dk, dv))
              if not torch.equal(a, b)]
    say("kernels", check="inputs 4 bytes off alignment, bf16", shape=shape,
        bit_equal_to_aligned=not differ)
    if differ:
        raise AssertionError(f"unaligned inputs changed {differ}")


def _sdpa_bwd_ms(q, k, v, g, n_iter: int) -> tuple[float, str]:
    """SDPA's backward alone (dq, dk and dv), flash backend, on the same
    inputs and output gradient: the forward runs once outside the timed
    region and each timed call is torch.autograd.grad over its graph.
    Where the flash backend refuses the shape, the first of the
    memory-efficient, cuDNN and math backends that takes it runs, and the
    note names it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    gh = g.transpose(1, 2)
    note = "flash backend, enable_gqa"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            try:
                out = sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
            except RuntimeError:
                rep = q.shape[2] // k.shape[2]
                kh, vh = (t.detach().repeat_interleave(rep, dim=1)
                          .requires_grad_() for t in (kh, vh))
                note = ("flash backend refused enable_gqa: k/v repeated to "
                        "H heads outside the timed region")
                out = sdpa(qh, kh, vh, is_causal=True)
    except RuntimeError:
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        for backend in (SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel(backend):
                    out = sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
                break
            except RuntimeError:
                continue
        note = (f"flash backend refused the shape; {backend.name} backend, "
                "enable_gqa")
    ms = cuda_ms_spread(lambda: torch.autograd.grad(
        out, (qh, kh, vh), gh, retain_graph=True), n_iter)[0]
    return ms, note


def phase_kernels() -> dict:
    """SMALL_SHAPES and WIDE_SHAPES against the plain versions, and
    check_unaligned; then bf16 at
    the main path's, small's and Gemma-2-9B's shapes (the last runs the
    three wgmma kernels at width 256) and at Gemma-2-9B's with heads of 512
    (the scalar kernels), causal: each
    kernel against the plain versions on the same bf16 inputs (BF16_TOL)
    and in f32 (BF16_VS_F32_TOL), then timed beside its bound, the plain
    version and SDPA (forward for fa_fwd; backward for the fa_bwd_dkv +
    fa_bwd_dq pair). Last, f32 at the main shape (the scalar kernels)
    against the f32 plain version (F32_TOL), beside SDPA in f32 with TF32
    off. Each time is the median of REPEATS runs of cuda_ms; the kernels'
    rows also carry the runs' min and max. Returns rows[kernel][shape
    label]."""
    check_kernels_small()
    check_kernels_small(WIDE_SHAPES)
    check_unaligned()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    main = (2, 2048, 32, 8, 128)
    for label, (B, S, H, KV, Dh), dt in [
            ("main", main, torch.bfloat16),
            ("small", (2, 2048, 12, 4, 64), torch.bfloat16),
            ("gemma2_9b", GEMMA2_9B, torch.bfloat16),
            ("gemma2_9b_dh512", GEMMA2_9B_DH512, torch.bfloat16),
            ("main_f32", main, torch.float32)]:
        q, k, v, g = _inputs(B, S, H, KV, Dh, dt, 0)
        res, lse, delta = _run_kernels(q, k, v, g, True)
        if dt == torch.float32:
            errs = errs_f32 = _check_against_plain(
                f"{label} f32", res, q, k, v, g, lse, delta, True, 128,
                F32_TOL)
        else:
            f32 = [t.float() for t in (q, k, v, g)]
            errs_f32 = _check_against_plain(f"{label} bf16 vs f32 plain", res,
                                            *f32, lse, delta, True, 128,
                                            BF16_VS_F32_TOL)
            errs = _check_against_plain(f"{label} bf16", res, q, k, v, g, lse,
                                        delta, True, 128, BF16_TOL)
            _check_dq_rounding(label, res[2], q, k, v, g, lse, delta, True,
                               128)

        n_iter = 10 if label == "main" else 5
        spread = {
            "fa_fwd": cuda_ms_spread(lambda: fa._flash_fwd_kernel(
                q, k, v, causal=True), n_iter),
            "fa_bwd_dkv": cuda_ms_spread(lambda: fa._bwd_dkv_kernel(
                q, k, v, g, lse, delta, causal=True), n_iter),
            "fa_bwd_dq": cuda_ms_spread(lambda: fa._bwd_dq_kernel(
                q, k, v, g, lse, delta, causal=True), n_iter),
        }
        ms = {name: med for name, (med, _, _) in spread.items()}
        # the f32 plain versions take 60-110 ms a call: one timed call each
        plain_iter = 1 if dt == torch.float32 else 2
        plain_fwd = cuda_ms(lambda: fa._flash_fwd_plain(
            q, k, v, causal=True, block_q=128, block_k=128), plain_iter)
        plain_bwd = cuda_ms(lambda: fa._flash_bwd_plain(
            q, k, v, g, lse, delta, causal=True, block_q=128, block_k=128),
            plain_iter)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cuda_ms_spread(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True), n_iter)[0]
        sdpa_bwd, sdpa_bwd_note = _sdpa_bwd_ms(q, k, v, g, n_iter)
        pairs = _pairs(B, S, H, True)
        e = q.element_size()
        qb, kvb, rowb = B * S * H * Dh * e, B * S * KV * Dh * e, B * H * S * 4
        work = {
            "fa_fwd": (qb + 2 * kvb + qb + rowb, 4 * Dh * pairs),
            "fa_bwd_dkv": (2 * qb + 2 * kvb + 2 * rowb + 2 * kvb, 8 * Dh * pairs),
            "fa_bwd_dq": (2 * qb + 2 * kvb + 2 * rowb + qb, 6 * Dh * pairs),
        }
        plain = {"fa_fwd": plain_fwd, "fa_bwd_dkv": plain_bwd,
                 "fa_bwd_dq": plain_bwd}
        library = {"fa_fwd": sdpa, "fa_bwd_dkv": sdpa_bwd, "fa_bwd_dq": sdpa_bwd}
        for name in KERNELS:
            bound, by = _bound_ms(*work[name], dt)
            row = {"ms": ms[name], "ms_min": spread[name][1],
                   "ms_max": spread[name][2], "plain_ms": plain[name],
                   "bound_ms": bound,
                   "bound_by": by, "max_abs_err": errs[name],
                   "max_abs_err_vs_f32_plain": errs_f32[name],
                   "library_ms": library[name],
                   "tflops": work[name][1] / ms[name] / 1e9}
            say("kernels", kernel=name, shape=label,
                **{k_: (f"{v_:.4g}" if isinstance(v_, float) else v_)
                   for k_, v_ in row.items()})
            rows.setdefault(name, {})[label] = row
        pair = ms["fa_bwd_dkv"] + ms["fa_bwd_dq"]
        say("kernels", shape=label, backward_pair_ms=f"{pair:.4g}",
            sdpa_backward_ms=f"{sdpa_bwd:.4g}",
            pair_over_sdpa=f"{pair / sdpa_bwd:.3g}", sdpa_backward=sdpa_bwd_note)
    say("kernels", note="plain_ms of the backward kernels is one plain "
        "backward computing dq, dk and dv together; library_ms is SDPA's "
        "forward for fa_fwd and SDPA's backward (dq, dk and dv) for the "
        "backward pair: yardsticks the port never calls")
    return rows


def phase_wide_path() -> dict[str, int]:
    """Phase 2b, the wide heads' path: flash_attention at Gemma-2-9B's
    attention shape (bf16, causal), the forward and then the backward
    through autograd, with the launch counts set to 0 just before and read
    just after; finite outputs of the right shapes. Returns the wide
    kernels' launches there (check_variants: each from the source its
    WIDE_KERNELS row names)."""
    B, S, H, KV, Dh = GEMMA2_9B
    q, k, v, g = _inputs(B, S, H, KV, Dh, torch.bfloat16, 4)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = fa.flash_attention(q, k, v, True)
    out.backward(g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    variants = dict(fa.VARIANT_LAUNCHES)
    grads = (q.grad, k.grad, v.grad)
    if out.shape != q.shape or any(t.shape != s.shape for t, s in
                                   zip(grads, (q, k, v))) \
            or not all(torch.isfinite(t).all() for t in (out, *grads)):
        raise AssertionError("wide path: outputs of the wrong shape or not "
                             "finite")
    say("wide_path", shape=GEMMA2_9B, dtype="bf16", causal=True,
        fwd_bwd_ms=f"{dt * 1e3:.2f}",
        launches=json.dumps(variants, sort_keys=True))
    return check_variants(WIDE_KERNELS, variants, "wide path")


# ---------------------------------------------------------------- ssd2gpu
def _drop_cache(path: str) -> None:
    """Evict *path* from the page cache, so the next read goes to disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def _write_file(path: str, data: np.ndarray) -> None:
    with open(path, "wb") as f:
        data.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    _drop_cache(path)


def _cpu_s() -> float:
    """This process's user + system CPU seconds (every thread of it)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _timed_delivery(label: str, call, want: torch.Tensor) -> tuple[float, float]:
    """(GB/s, host CPU s per GiB) of one delivery, checked byte for byte."""
    cpu0, t0 = _cpu_s(), time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    dt, cpu = time.perf_counter() - t0, _cpu_s() - cpu0
    if out.device.type != "cuda" or not torch.equal(out, want):
        bad = (out.reshape(-1) != want.reshape(-1)).nonzero()
        raise AssertionError(
            f"ssd2gpu {label}: delivered bytes differ from the file: "
            f"{bad.numel()} bytes, first at {bad[:1].tolist()}, last at "
            f"{bad[-1:].tolist()}")
    gbps, cpu_per_gib = want.numel() / dt / 1e9, cpu / (want.numel() / GiB)
    say("ssd2gpu", read=label, bytes=want.numel(), s=f"{dt:.4f}",
        gbps=f"{gbps:.3f}", cpu_s_per_gib=f"{cpu_per_gib:.4f}", exact=True)
    return gbps, cpu_per_gib


def engine_report() -> tuple[bool, str]:
    """The [engine] line; returns (io_uring available, errno name or "")."""
    t0 = time.perf_counter()
    avail = uring_engine.uring_available()
    probe_s = time.perf_counter() - t0
    err = uring_engine.create_errno
    err_name = errno.errorcode.get(err, str(err)) if err else ""
    sysctl = "/proc/sys/kernel/io_uring_disabled"
    disabled = open(sysctl).read().strip() if os.path.exists(sysctl) \
        else "absent"
    eng = make_engine(StromConfig.from_env(engine="auto"))
    chosen = eng.stats()["engine"]
    eng.close()
    build_s = core_build.build_seconds
    # io_uring's buffer registration counts against RLIMIT_MEMLOCK unless
    # the process holds CAP_IPC_LOCK: a refusal shows as dest_refused
    memlock = resource.getrlimit(resource.RLIMIT_MEMLOCK)[0]
    with open("/proc/self/status") as f:
        capeff = next(int(line.split()[1], 16) for line in f
                      if line.startswith("CapEff:"))
    say("engine", uring_available=avail,
        sc_create_errno=(err_name or ("none" if avail else "n/a")),
        reason=(uring_engine.unavailable_reason or "-").replace(" ", "_"),
        io_uring_disabled=disabled, auto_chose=chosen,
        native_build_s=(f"{build_s:.2f}" if build_s is not None else "cached"),
        probe_s=f"{probe_s:.2f}",
        memlock_limit=("unlimited" if memlock == resource.RLIM_INFINITY
                       else memlock),
        cap_ipc_lock=bool(capeff >> 14 & 1))
    if not avail and not err:
        # the kernel was never asked: the port's native library did not
        # build or load, which is a fault of the port, not of the machine
        raise AssertionError(f"native engine unavailable without an errno: "
                             f"{uring_engine.unavailable_reason}")
    return avail, err_name


def _engine_only(eng, fi: int, slab: np.ndarray, path: str) -> tuple[float, float]:
    """(GB/s, CPU s per GiB) of one engine reading the cold file whole."""
    _drop_cache(path)
    cpu0, t0 = _cpu_s(), time.perf_counter()
    if eng.read_vectored([(fi, 0, 0, GiB)], slab) != GiB:
        raise AssertionError(f"{eng.name} engine-only read came up short")
    dt, cpu = time.perf_counter() - t0, _cpu_s() - cpu0
    return GiB / dt / 1e9, cpu


SCHED_ROUNDS = 4
# the engine-alone median of phase 3's [sched] arms, GB/s: phase 10 prices
# one scheduler slice at it
ENGINE_ALONE_GBPS: list[float] = []


def _sched_arms(path: str, want: torch.Tensor, eng, fi: int,
                slab: np.ndarray, yard: str) -> None:
    """Phase 3's [sched] arms: the 1 GiB streamed delivery through a
    context with the scheduler (the default) and through one without it,
    beside the engine alone, the three in alternating order; every
    delivery exact. Prints each arm's GB/s, both deliveries' ratio to the
    engine alone, and the scheduler's grants, which must cover exactly the
    bytes delivered through it."""
    ctxs = {"sched_on": StromContext(StromConfig.from_env(engine="auto")),
            "sched_off": StromContext(StromConfig.from_env(
                engine="auto", sched_enabled=False))}
    if ctxs["sched_on"].scheduler is None or \
            ctxs["sched_off"].scheduler is not None:
        raise AssertionError("sched: StromContext() must build a scheduler "
                             "by default, and sched_enabled=False none")
    for c in ctxs.values():
        # untimed: each context pins its pool's slabs on its first delivery
        _drop_cache(path)
        out = c.memcpy_ssd2gpu(path, device="cuda")
        torch.cuda.synchronize()
        del out
    arms = ["engine", "sched_on", "sched_off"]
    res: dict[str, list[float]] = {a: [] for a in arms}
    for i in range(SCHED_ROUNDS):
        for arm in (arms if i % 2 == 0 else arms[::-1]):
            if arm == "engine":
                res[arm].append(_engine_only(eng, fi, slab, path)[0])
                continue
            _drop_cache(path)
            res[arm].append(_timed_delivery(
                f"1GiB-streamed-{arm}-round{i}",
                lambda c=ctxs[arm]: c.memcpy_ssd2gpu(path, device="cuda"),
                want)[0])
        say("sched", round=i,
            order="-".join(arms if i % 2 == 0 else arms[::-1]),
            **{f"{a}_gbps": f"{res[a][-1]:.3f}" for a in arms},
            **{f"{a}_vs_engine": f"{res[a][-1] / res['engine'][-1]:.3f}"
               for a in arms[1:]}, engine_arm=yard)
    sched = ctxs["sched_on"].scheduler
    st = sched.stats()
    tenant = sched.tenant(None)
    say("sched", **{k: v for k, v in st.items()},
        slice_bytes=sched._slice_bytes(),
        default_tenant_granted_ops=tenant.granted_ops,
        default_tenant_granted_bytes=tenant.granted_bytes,
        **{f"{a}_gbps_median": f"{statistics.median(res[a]):.4f}"
           for a in arms},
        **{f"{a}_vs_engine_median":
           f"{statistics.median(res[a]) / statistics.median(res['engine']):.4f}"
           for a in arms[1:]})
    ENGINE_ALONE_GBPS.append(statistics.median(res["engine"]))
    if st["sched_granted_bytes"] != (SCHED_ROUNDS + 1) * GiB \
            or st["sched_active_grants"] != 0:
        raise AssertionError(f"sched: granted {st['sched_granted_bytes']} "
                             f"bytes for {SCHED_ROUNDS + 1} GiB delivered: "
                             f"{st}")
    for c in ctxs.values():
        c.close()


def phase_ssd2gpu(workdir: str) -> str:
    """A seeded 1 GiB file into device memory under engine="auto": 64 MiB
    unstreamed (twice: the first call also pins and ring-registers the
    pool's slab), then the whole file streamed, sync and async; every byte
    compared on the card. Then four rounds of engine-only reads by each
    engine beside a delivery, and the striped deliveries. Returns the
    file's path."""
    uring_ok, why_not = engine_report()
    path = os.path.join(workdir, "ssd2gpu.bin")
    data = np.frombuffer(bytearray(np.random.default_rng(0).bytes(GiB)),
                         dtype=np.uint8)
    _write_file(path, data)
    want = torch.from_numpy(data).to("cuda")
    del data
    ctx = strom_torch.init(StromConfig.from_env(engine="auto"))
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
    eng = st["engine"]
    say("ssd2gpu", stats=json.dumps(st, sort_keys=True))
    say("ssd2gpu", engine=eng["engine"],
        **{k: eng.get(k, "n/a") for k in (
            "engine_fixed_buf_ratio", "ops_fixed", "ops_submitted",
            "cached_bytes", "media_bytes", "ext_buffers")},
        refused_slab_registrations=eng.get("dest_refused", "n/a"))
    if uring_ok and eng["engine"] != "uring":
        raise AssertionError(f"engine=auto chose {eng['engine']} though "
                             f"io_uring is available")

    # The yardstick of a delivery: each engine alone reading the cold file
    # into a prefaulted host slab, as the pool's slabs are (the io_uring
    # engine's slab registered with its ring, as the pool's are). The
    # disk's rate drifts within a run, so the arms alternate their order.
    slab = alloc_aligned(GiB, populate=True)
    engines = {"python": PythonEngine(StromConfig.from_env(engine="python"))}
    if uring_ok:
        engines["uring"] = uring_engine.UringEngine(
            StromConfig.from_env(engine="uring"))
        if engines["uring"].register_dest(slab) < 0:
            say("ssd2gpu", note="the ring refused the engine-only slab")
    files = {name: e.register_file(path) for name, e in engines.items()}
    yard = "uring" if uring_ok else "python"
    arms = ["python", "uring", "delivered"]
    res: dict[str, list[tuple[float, float]]] = {a: [] for a in arms}
    ratios = []
    for i in range(4):
        for arm in (arms if i % 2 == 0 else arms[::-1]):
            if arm == "uring" and not uring_ok:
                continue
            if arm == "delivered":
                _drop_cache(path)
                res[arm].append(_timed_delivery(
                    f"1GiB-streamed-round{i}", lambda: strom_torch.memcpy_ssd2gpu(
                        path, device="cuda"), want))
            else:
                res[arm].append(_engine_only(engines[arm], files[arm], slab,
                                             path))
        ratios.append(res["delivered"][-1][0] / res[yard][-1][0])
        say("ssd2gpu", round=i, order="-".join(arms if i % 2 == 0 else arms[::-1]),
            **{f"{a}_gbps": (f"{res[a][-1][0]:.3f}" if res[a] else
                             f"skipped={why_not}") for a in arms},
            **{f"{a}_cpu_s_per_gib": f"{res[a][-1][1]:.4f}"
               for a in arms if res[a]},
            delivered_vs=yard, ratio=f"{ratios[-1]:.3f}")
    if not torch.equal(torch.from_numpy(slab).to("cuda"), want):
        raise AssertionError("engine-only read differs from the file")
    _sched_arms(path, want, engines[yard], files[yard], slab, yard)
    if uring_ok:
        ust = engines["uring"].stats()
        say("ssd2gpu", arm="uring-engine-only",
            engine_fixed_buf_ratio=f"{ust['engine_fixed_buf_ratio']:.4f}",
            ops_fixed=ust["ops_fixed"], media_bytes=ust["media_bytes"],
            cached_bytes=ust["cached_bytes"])
    for e in engines.values():
        e.close()
    summary = {f"{a}_gbps_median": statistics.median(g for g, _ in res[a])
               for a in arms if res[a]}
    summary.update({f"{a}_cpu_s_per_gib_median":
                    statistics.median(c for _, c in res[a])
                    for a in arms if res[a]})
    say("ssd2gpu", delivered_vs_engine_only_median=f"{statistics.median(ratios):.3f}",
        engine_only_arm=yard, pairs=len(ratios),
        **{k: f"{v:.4f}" for k, v in summary.items()})
    # the other half of a delivery: one host-to-device copy of 1 GiB out of
    # pinned memory (into a tensor of its own: want stays the file's bytes)
    pinned = torch.empty(GiB, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty_like(want)
    h2d_ms = cuda_ms(lambda: dst.copy_(pinned, non_blocking=True), 3)
    del pinned, dst
    say("ssd2gpu", read="1GiB-pinned-host-to-device-copy", ms=f"{h2d_ms:.3f}",
        gbps=f"{GiB / h2d_ms / 1e6:.3f}")
    _drop_cache(path)
    report_check("file", strom_torch.check_file(path))
    phase_ssd2host(ctx, path, slab, want)
    strom_torch.close()
    del slab
    phase_striped(workdir, path, want, uring_ok, why_not)
    return path   # phase 5 gathers records of it


def report_check(label: str, rep) -> None:
    """The [check] line of one check_file report."""
    say("check", of=label, tier=rep.tier.value, supported=rep.supported,
        fs_type=rep.fs_type, size=rep.size, extents=rep.extents,
        extent_coverage=f"{rep.extent_coverage:.3f}",
        fragmented=rep.fragmented, mean_extent_bytes=rep.mean_extent_bytes,
        cached_frac=("none" if rep.cached_frac is None
                     else f"{rep.cached_frac:.3f}"),
        device=(f"{rep.device.name}:{rep.device.fast_class}" if rep.device
                else "none"),
        dio=f"{rep.dio.source}:{rep.dio.offset_align}",
        reason=rep.reasons[-1].replace(" ", "_") if rep.reasons else "-")
    if rep.size <= 0 or not 0.0 <= (rep.cached_frac or 0.0) <= 1.0:
        raise AssertionError(f"check_file {label}: {rep}")


def _host_exact(label: str, host: np.ndarray, want: torch.Tensor) -> None:
    if not torch.equal(torch.from_numpy(host).to(want.device), want):
        raise AssertionError(f"ssd2host {label}: bytes differ from the file")


def phase_ssd2host(ctx, path: str, slab: np.ndarray, want: torch.Tensor
                   ) -> None:
    """memcpy_ssd2host (the delivered path stopped before the copy to the
    device: planning, residency routing, the gather) against the same
    context's engine reading the dropped file into the same slab, and
    against memcpy_ssd2host with the residency hybrid off (every aligned
    read O_DIRECT), in four rounds of alternating order; then one
    memcpy_ssd2host of the file read once through the page cache, with the
    engine's cached_bytes and media_bytes."""
    fi = ctx.file_index(path)
    off = StromContext(dataclasses.replace(ctx.config, residency_hybrid=False))
    arms = ("raw", "ssd2host", "ssd2host_hybrid_off")
    res: dict[str, list[float]] = {a: [] for a in arms}
    for i in range(4):
        order = arms if i % 2 == 0 else arms[::-1]
        for arm in order:
            _drop_cache(path)
            t0 = time.perf_counter()
            if arm == "raw":
                if ctx.engine.read_vectored([(fi, 0, 0, GiB)], slab) != GiB:
                    raise AssertionError("ssd2host: the raw read came up short")
                out = slab
            else:
                out = (ctx if arm == "ssd2host" else off).memcpy_ssd2host(
                    path, out=slab)
            dt = time.perf_counter() - t0
            if not np.shares_memory(out, slab):
                raise AssertionError("ssd2host: out= was not the dest")
            res[arm].append(GiB / dt / 1e9)
            _host_exact(f"{arm} round {i}", slab, want)
        say("ssd2host", round=i, order="-".join(order),
            **{f"{a}_gbps": f"{res[a][-1]:.3f}" for a in arms},
            vs_raw=f"{res['ssd2host'][-1] / res['raw'][-1]:.3f}")
    med = {a: statistics.median(res[a]) for a in arms}
    ost = off.engine.stats()
    off.close()
    say("ssd2host", engine=ctx.engine.name,
        **{f"{a}_gbps_median": f"{m:.4f}" for a, m in med.items()},
        vs_raw=f"{med['ssd2host'] / med['raw']:.4f}",
        hybrid_off_vs_on=f"{med['ssd2host_hybrid_off'] / med['ssd2host']:.4f}",
        hybrid_off_media_bytes=ost.get("media_bytes", "n/a"),
        hybrid_off_cached_bytes=ost.get("cached_bytes", "n/a"),
        rounds=4, exact=True)
    # warm: the whole file read once through the page cache first
    with open(path, "rb") as f:
        while f.readinto(memoryview(slab)[:64 * MiB]):
            pass
    warm_frac = strom_torch.check_file(path, want_extents=False).cached_frac
    before = dict(ctx.engine.stats())
    t0 = time.perf_counter()
    strom_torch.memcpy_ssd2host(path, out=slab)
    dt = time.perf_counter() - t0
    _host_exact("warm", slab, want)
    after = ctx.engine.stats()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("cached_bytes", "media_bytes", "residency_probes")}
    say("ssd2host", read="1GiB-warm", engine=after["engine"],
        residency_hybrid=ctx.config.residency_hybrid,
        o_direct=ctx.uses_o_direct(path),
        cached_frac_before=("none" if warm_frac is None else f"{warm_frac:.3f}"),
        gbps=f"{GiB / dt / 1e9:.3f}", exact=True, **delta)
    if ctx.uses_o_direct(path) and delta["cached_bytes"] + \
            delta["media_bytes"] != GiB:
        raise AssertionError(f"ssd2host warm: the engine routed "
                             f"{delta} bytes of a 1 GiB read")


def phase_striped(workdir: str, path: str, want: torch.Tensor,
                  uring_ok: bool, why_not: str) -> None:
    """The 1 GiB file striped RAID0 over 4 member files (512 KiB chunks),
    aliased with register_striped and delivered to the card under 4 rings
    and under 1: exact bytes, and with 4 rings bytes on every ring."""
    chunk = StromConfig().raid_chunk
    t0 = time.perf_counter()
    members = _stripe_members(path, 4, chunk)
    say("striped", members=len(members), raid_chunk=chunk,
        stripe_s=f"{time.perf_counter() - t0:.2f}")
    alias = os.path.join(workdir, "striped.bin")
    report_check("striped-set", strom_torch.check_file(StripedFile(
        tuple(members), chunk)))
    for rings in (4, 1):
        ctx = strom_torch.init(StromConfig.from_env(engine="auto",
                                                    engine_rings=rings))
        sf = strom_torch.register_striped(alias, members, chunk)
        if sf.size != GiB:
            raise AssertionError(f"striped size {sf.size}")
        for m in members:
            _drop_cache(m)
        gbps, cpu = _timed_delivery(f"1GiB-striped-{rings}ring",
                                    lambda: strom_torch.memcpy_ssd2gpu(
                                        alias, device="cuda"), want)
        eng = strom_torch.stats()["engine"]
        ring_bytes = [r["bytes_read"] for r in eng.get("ring_stats", [])]
        if rings > 1 and uring_ok and not (
                eng["engine"] == "multi" and len(ring_bytes) == rings
                and all(b > 0 for b in ring_bytes)):
            raise AssertionError(f"4 rings: bytes per ring {ring_bytes} "
                                 f"on engine {eng['engine']}")
        say("striped", rings=rings, engine=eng["engine"],
            ring_bytes=(json.dumps(ring_bytes) if ring_bytes else
                        (f"skipped={why_not}" if rings > 1 else "one_ring")),
            gbps=f"{gbps:.3f}", cpu_s_per_gib=f"{cpu:.4f}",
            engine_fixed_buf_ratio=eng.get("engine_fixed_buf_ratio", "n/a"),
            media_bytes=eng.get("media_bytes", "n/a"),
            cached_bytes=eng.get("cached_bytes", "n/a"))
        strom_torch.close()


# ------------------------------------------------------------------ train
def phase_train(workdir: str) -> dict[str, int]:
    """Packed-token shards → make_llama_pipeline → make_train_step at
    Llama-3-8B widths, 2 layers, flash attention, captured: 4 counted steps
    (warm-up, capture, 2 replays), 4 more replays timed, one profiled; then
    the captured step against its eager body. Returns the launches during
    the counted steps of each row of KERNELS (check_variants: each from the
    source its row names) and of F32_KERNELS and DH512_KERNELS (no scalar
    call is on this path: 0 unless one was)."""
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    B, seq_len, steps, timed, records = 2, 2047, 4, 4, 16
    rng = np.random.default_rng(1)
    shards = [rng.integers(0, cfg.vocab, (records, seq_len + 1), dtype=np.int32)
              for _ in range(2)]
    ctx = strom_torch.init(StromConfig.from_env())
    say("train", engine=ctx.engine.stats()["engine"])
    paths = []
    for i, toks in enumerate(shards):
        paths.append(os.path.join(workdir, f"tokens{i}.bin"))
        write_token_shard(ctx, paths[-1], toks)
    all_records = torch.from_numpy(np.concatenate(shards)).to("cuda")
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
    times, calls, variants = [], [], {}
    for i in range(steps + timed):
        batch = first if i == 0 else next_batch()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        calls.append(step.last_call)
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"step {i}: loss {loss}, grad_norm {norm}")
        say("train", step=i, call=step.last_call, loss=f"{loss:.5f}",
            grad_norm=f"{norm:.5f}", ms=f"{times[-1] * 1e3:.1f}")
        if i == steps - 1:   # the launches of the first `steps` steps
            variants = dict(fa.VARIANT_LAUNCHES)
    steady = [t for t, c in zip(times, calls) if c == "replay"]
    say("train", **_step_summary(step, times, calls, steady),
        tokens_per_s=f"{B * (seq_len + 1) / statistics.mean(steady):.0f}",
        max_memory_allocated_gib=f"{torch.cuda.max_memory_allocated() / GiB:.2f}",
        data_stall_steps=pipe.data_stall_steps,
        launches=json.dumps(variants, sort_keys=True), launches_over_steps=steps)
    profile_step(step, state, next_batch())
    pipe.close()
    strom_torch.close()
    del state, step
    torch.cuda.empty_cache()
    # the captured step against its eager body: 4 steps each from fresh
    # states of one seed on the first 4 batches of the shards' records
    fa.reset_launch_counts()
    batches = [all_records[2 * i:2 * i + 2] for i in range(4)]
    _captured_equals_eager(
        "train", lambda: make_train_step(cfg, attn="flash", device="cuda"),
        lambda: init_train_state(cfg, device="cuda", seed=0),
        lambda step, state, b: step(state, b)[1], batches,
        lambda state: {"wq": state.model.wq[:, :64, :64],
                       "w_down": state.model.w_down[:, :64, :64],
                       "embed": state.model.embed[:64],
                       "lm_head": state.model.lm_head[:, :64],
                       "attn_norm": state.model.attn_norm})
    launches = check_variants(KERNELS, variants, "train steps")
    return launches | {name: variants.get(info["variant"], 0)
                       for table in (F32_KERNELS, DH512_KERNELS)
                       for name, info in table.items()}


# ------------------------------------------------------- write and ckpt
WRITE_ROUNDS = 2
CKPT_STEPS, RESUME_STEPS, ASYNC_SAVES, ASYNC_REPLAYS = 3, 3, 2, 2
CKPT_DEVICE = "cuda"   # the phase's device ("cpu" rehearses it at a tiny size)
CKPT_CONFIG = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
CKPT_SEQ = 2047


def _write_counts(ctx) -> dict:
    """The engine's write counters (the preadv pool counts its routes; the
    io_uring engine its ops and bytes only)."""
    st = ctx.engine.stats()
    return {k: st[k] for k in ("direct_writes", "buffered_writes",
                                "unaligned_fallback_writes", "ops_written",
                                "bytes_written") if k in st}


def _os_pwrite(path: str, data: np.ndarray) -> None:
    """The plain arm: os.pwrite of the whole buffer, then fsync."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        view, off = memoryview(data), 0
        while off < len(view):
            off += os.pwrite(fd, view[off:], off)
        os.fsync(fd)
    finally:
        os.close(fd)


def phase_write(workdir: str) -> None:
    """[write]: 1 GiB of seeded bytes through ctx.pwrite (the engine's
    write path, fsync) and through os.pwrite plus fsync, alternating:
    GB/s, host CPU s per GiB, the engine's direct, buffered and unaligned
    write counts, the bytes read back exact."""
    data = alloc_aligned(GiB)
    data[:] = np.frombuffer(np.random.default_rng(21).bytes(GiB), np.uint8)
    ctx = StromContext(StromConfig.from_env())
    try:
        for rnd in range(WRITE_ROUNDS):
            for arm in ("engine", "os"):
                path = os.path.join(workdir, f"write_{arm}.bin")
                before = _write_counts(ctx)
                cpu0, t0 = _cpu_s(), time.perf_counter()
                if arm == "engine":
                    n = ctx.pwrite(path, data, fsync=True)
                else:
                    _os_pwrite(path, data)
                    n = GiB
                dt, cpu = time.perf_counter() - t0, _cpu_s() - cpu0
                counts = {k: v - before[k]
                          for k, v in _write_counts(ctx).items()}
                _drop_cache(path)
                back = ctx.pread(path)
                exact = n == GiB and back.nbytes == GiB \
                    and np.array_equal(back, data)
                if not exact:
                    raise AssertionError(f"write {arm}: the bytes read back "
                                         "differ from the bytes written")
                extra = {"o_direct": ctx.uses_o_direct(path), **counts} \
                    if arm == "engine" else {}
                say("write", round=rnd, arm=arm, bytes=n, s=f"{dt:.4f}",
                    gbps=f"{n / dt / 1e9:.3f}",
                    cpu_s_per_gib=f"{cpu / (n / GiB):.4f}", **extra,
                    readback_exact=exact)
                del back
                ctx.invalidate_file(path)
                os.unlink(path)
        st = ctx.stats()
        say("write", engine=st["engine"]["engine"],
            host2ssd_bytes=st["context"]["host2ssd_bytes"])
    finally:
        ctx.close()


def _leaves(state) -> list:
    return tree_flatten(train_state_tree(state))[0]


def _differ(got: list, want: list) -> list[int]:
    """Indices of the leaves that are not equal (tensors: torch.equal on
    their own devices)."""
    return [i for i, (a, b) in enumerate(zip(got, want))
            if not (torch.equal(a, b.to(a.device))
                    if isinstance(a, torch.Tensor) else a == b)]


def _run_steps(step, state, pipe, n: int) -> tuple[object, list]:
    out = []
    for _ in range(n):
        state, m = step(state, next(pipe))
        out.append((m["loss"], m["grad_norm"]))
    if state.model.embed.is_cuda:
        torch.cuda.synchronize()
    return state, out


def _series(metrics: list) -> str:
    return ",".join(f"{float(loss):.6f}/{float(norm):.6f}"
                    for loss, norm in metrics)


def phase_ckpt(workdir: str) -> dict[str, int]:
    """Phase 4b: the write path, then checkpoints of phase 4's train state
    (Llama-3-8B widths, 2 layers, bf16, flash, fused AdamW, captured, fed
    by make_llama_pipeline from the engine): a blocking save against the
    pickle baseline, the restore into a fresh state and a fresh pipeline
    whose steps must equal the uninterrupted run's bit for bit, and an
    async save under replays. Returns the resumed steps' launches per
    kernel (check_variants)."""
    phase_write(workdir)
    usage = shutil.disk_usage(workdir)
    say("ckpt", disk_total_gb=f"{usage.total / 1e9:.1f}",
        disk_free_gb=f"{usage.free / 1e9:.1f}")
    cfg, dev = CKPT_CONFIG, CKPT_DEVICE
    B, seq_len, records = 2, CKPT_SEQ, 16
    ctx = StromContext(StromConfig.from_env())
    rng = np.random.default_rng(2)
    paths = []
    for i in range(2):
        paths.append(os.path.join(workdir, f"ckpt_tokens{i}.bin"))
        write_token_shard(ctx, paths[-1], rng.integers(
            0, cfg.vocab, (records, seq_len + 1), dtype=np.int32))

    def pipeline(resume_from=None):
        return make_llama_pipeline(ctx, paths, batch=B, seq_len=seq_len,
                                   device=dev, seed=0,
                                   resume_from=resume_from)

    pipe = pipeline()
    state = init_train_state(cfg, device=dev, seed=0)
    step = make_train_step(cfg, attn="flash", device=dev)
    state, first = _run_steps(step, state, pipe, CKPT_STEPS)

    # the blocking save at step k, with its resume token
    tree = train_state_tree(state)
    token = StepToken(sampler=pipe.state(), consumed=CKPT_STEPS,
                      prefetch_depth=pipe.prefetch_depth,
                      fingerprint=pipe.fingerprint)
    # the state at step k, copied to the host: the roundtrip's and the
    # pickle's reference
    t0 = time.perf_counter()
    host, treedef = _host_leaves(tree, snapshot=True)
    snapshot_s = time.perf_counter() - t0
    d1 = os.path.join(workdir, "ckpt_sync")
    before = _write_counts(ctx)
    d2h_us = ctx.stats().get("ckpt_d2h_us", 0)
    t0 = time.perf_counter()
    manifest = save_checkpoint(ctx, d1, tree, extra={TOKEN_KEY:
                                                     token.to_dict()})
    save_s = time.perf_counter() - t0
    d2h_s = (ctx.stats()["ckpt_d2h_us"] - d2h_us) / 1e6
    payload = manifest["payload_bytes"]
    save_mb_s = payload / save_s / 1e6
    counts = {k: v - before[k] for k, v in _write_counts(ctx).items()}
    say("ckpt", arm="save", ckpt_bytes=payload,
        total_bytes=manifest["total_bytes"], ckpt_leaves=len(host),
        s=f"{save_s:.3f}", ckpt_save_mb_per_s=f"{save_mb_s:.1f}",
        d2h_s=f"{d2h_s:.3f}", d2h_share=f"{d2h_s / save_s:.3f}",
        host_snapshot_s=f"{snapshot_s:.3f}", **counts)
    del tree

    # the uninterrupted run goes on
    state, uninterrupted = _run_steps(step, state, pipe, RESUME_STEPS)
    pipe.close()

    # restore into a fresh state on the card and a fresh pipeline
    fresh = init_train_state(cfg, device=dev, seed=1)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    restored = restore_checkpoint(ctx, d1, train_state_tree(fresh))
    sync()
    restore_s = time.perf_counter() - t0
    got = tree_flatten(restored)[0]
    off_card = [i for i, t in enumerate(got) if isinstance(t, torch.Tensor)
                and t.device.type != torch.device(dev).type]
    bad = _differ(got, [h.obj if isinstance(h.obj, torch.Tensor)
                        else h.obj.item() for h in host])
    roundtrip_ok = not bad and not off_card
    say("ckpt", arm="restore", s=f"{restore_s:.3f}",
        ckpt_restore_mb_per_s=f"{payload / restore_s / 1e6:.1f}",
        on_card=not off_card, ckpt_roundtrip_ok=roundtrip_ok,
        differ=",".join(map(str, bad)) or "none")
    if not roundtrip_ok:
        raise AssertionError(f"ckpt: restored leaves {bad} differ, leaves "
                             f"{off_card} left the card")
    load_train_state(fresh, restored)
    del restored, got
    resumed = pipeline(StepToken.from_manifest(load_manifest(d1)).sampler)
    resumed_step = make_train_step(cfg, attn="flash", device=dev)
    fa.reset_launch_counts()
    fresh, after = _run_steps(resumed_step, fresh, resumed, RESUME_STEPS)
    variants = dict(fa.VARIANT_LAUNCHES)
    launches = check_variants(KERNELS, variants, "resumed steps")
    same_steps = all(torch.equal(a, c) and torch.equal(b, d)
                     for (a, b), (c, d) in zip(after, uninterrupted))
    bad = _differ(_leaves(fresh), _leaves(state))
    resume_ok = same_steps and not bad
    say("ckpt", arm="resume", steps_before=CKPT_STEPS,
        steps_after=RESUME_STEPS, uninterrupted=_series(uninterrupted),
        resumed=_series(after), calls=resumed_step.last_call,
        leaves_differ=",".join(map(str, bad)) or "none",
        launches=json.dumps(launches, sort_keys=True), resume_ok=resume_ok)
    if not resume_ok:
        raise AssertionError("ckpt: the resumed run differs from the "
                             "uninterrupted one")
    del state, step
    shutil.rmtree(d1)
    torch.cuda.empty_cache()

    # the pickle baseline of the same host leaves
    pk = os.path.join(workdir, "state.pkl")
    host_tree = tree_unflatten(treedef, [h.obj for h in host])
    t0 = time.perf_counter()
    pk_bytes = save_pickle(pk, host_tree)
    pickle_s = time.perf_counter() - t0
    pickle_mb_s = payload / pickle_s / 1e6
    bad = _differ(tree_flatten(load_pickle(pk))[0],
                  tree_flatten(host_tree)[0])
    os.unlink(pk)
    say("ckpt", arm="pickle", bytes=pk_bytes, s=f"{pickle_s:.3f}",
        ckpt_pickle_save_mb_per_s=f"{pickle_mb_s:.1f}",
        ckpt_save_vs_pickle=f"{save_mb_s / pickle_mb_s:.3f}",
        roundtrip_ok=not bad)
    if bad:
        raise AssertionError(f"ckpt: pickle leaves {bad} differ")
    del host, host_tree

    # async saves, the captured step replaying while each commits: the
    # first save also makes the checkpointer's pinned arena, the second
    # reuses it
    d2 = os.path.join(workdir, "ckpt_async")
    with AsyncCheckpointer(ctx, d2) as cp:
        for save in range(ASYNC_SAVES):
            at_save = [t.clone() if isinstance(t, torch.Tensor) else t
                       for t in _leaves(fresh)]
            t0 = time.perf_counter()
            cp.save(train_state_tree(fresh))
            stall_s = time.perf_counter() - t0
            draining = cp.in_flight
            fresh, _ = _run_steps(resumed_step, fresh, resumed,
                                  ASYNC_REPLAYS)
            cp.wait()
            commit_s = time.perf_counter() - t0
            moved = len(_differ(_leaves(fresh), at_save))
            template = tree_unflatten(
                tree_flatten(train_state_tree(fresh))[1], at_save)
            bad = _differ(tree_flatten(restore_checkpoint(ctx, d2, template)
                                       )[0], at_save)
            say("ckpt", arm="async", save=save,
                stall_ms=f"{stall_s * 1e3:.1f}",
                blocking_save_ms=f"{save_s * 1e3:.1f}",
                stall_frac=f"{stall_s / save_s:.3f}",
                commit_s=f"{commit_s:.3f}",
                replays_during_commit=ASYNC_REPLAYS,
                commit_in_flight=draining,
                replay_calls=resumed_step.last_call, leaves_moved=moved,
                equal_to_state_at_save=not bad)
            if bad or not moved:
                raise AssertionError(
                    f"ckpt: async checkpoint leaves {bad} differ from the "
                    f"state at the save ({moved} moved)")
            del at_save, template
    shutil.rmtree(d2)
    resumed.close()
    ctx.close()
    del fresh, resumed_step
    torch.cuda.empty_cache()
    return launches


def _step_summary(step, times: list[float], calls: list[str],
                  steady: list[float]) -> dict:
    """What a phase prints of its captured step: captured=true, the graphs,
    the warm-up call's and the capturing call's ms (where this phase made
    them), and the *steady* (replay) ms, mean and median."""
    if any(c not in ("warmup", "capture", "replay") for c in calls):
        raise AssertionError(f"a step on the card ran uncaptured: {calls}")
    if not steady:
        raise AssertionError(f"no call replayed a graph: {calls}")
    out = {"captured": "true", "graphs": step.graphs}
    for kind in ("warmup", "capture"):
        if kind in calls:
            out[f"step_ms_{kind}"] = f"{times[calls.index(kind)] * 1e3:.1f}"
    return out | {"step_ms_steady": f"{statistics.mean(steady) * 1e3:.2f}",
                  "step_ms_median": f"{statistics.median(steady) * 1e3:.2f}",
                  "steady_steps": len(steady)}


def _captured_equals_eager(label: str, make_step, make_owner, call,
                           batches: list, sample) -> None:
    """len(batches) steps of a captured step (warm-up, capture, replays)
    and as many of its eager body (``step.eager``), each on a fresh owner
    from one seed, on the same batches: the losses, grad norms and a
    *sample* of the owner's parameters must be bit-equal, since the same
    kernels run in the same order. *call(fn, owner, batch)* takes one step
    and returns its metrics."""

    def run(captured: bool):
        step, owner = make_step(), make_owner()
        fn = step if captured else step.eager
        metrics = [call(fn, owner, b) for b in batches]
        if captured and (step.graphs != 1 or step.last_call != "replay"):
            raise AssertionError(f"{label}: the captured run made "
                                 f"{step.graphs} graphs, last {step.last_call}")
        return ([(m["loss"], m["grad_norm"]) for m in metrics],
                {k: v.detach().clone() for k, v in sample(owner).items()})

    got, gp = run(True)
    torch.cuda.empty_cache()
    want, wp = run(False)
    torch.cuda.empty_cache()
    diff = [name for name in gp if not torch.equal(gp[name], wp[name])]
    diff += [f"step {i}" for i, (a, b) in enumerate(zip(got, want))
             if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
    say(label, check="captured steps against the eager body, bit for bit",
        steps=len(batches), losses=",".join(f"{float(a):.6f}" for a, _ in got),
        params_sampled=",".join(sorted(gp)), differ=",".join(diff) or "none")
    if diff:
        raise AssertionError(f"{label}: captured and eager steps differ: {diff}")


def _kernel_group(name: str) -> str:
    for kernel, info in KERNELS.items():
        if any(sym in name for sym in info["symbols"]):
            return kernel
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    # cuDNN's convolutions: implicit-GEMM fprop / dgrad / wgrad kernels
    if any(s in low for s in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "implicit_gemm", "winograd")):
        return "conv"
    if "batch_norm" in low or "batchnorm" in low or "bn_" in low:
        return "batch_norm"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    return "other"


# ----------------------------------------------------------------- stream
def _check_tiling(ranges: list[tuple[int, int]], size: int, label: str) -> None:
    """The completed ranges cover [0, size) exactly once."""
    pos = 0
    for lo, hi in sorted(ranges):
        if lo != pos or hi <= lo:
            raise AssertionError(f"{label}: ranges do not tile the dest at "
                                 f"{pos} (next range {lo}..{hi})")
        pos = hi
    if pos != size:
        raise AssertionError(f"{label}: ranges end at {pos}, dest is {size}")


def _drive(g) -> tuple[list[tuple[int, int]], int]:
    """Poll a streamed gather to its end: (completed ranges, poll calls)."""
    ranges: list[tuple[int, int]] = []
    polls = 0
    while not g.done:
        ranges.extend(g.poll(min_completions=1, timeout_s=0.05))
        polls += 1
    return ranges, polls


def phase_stream(path: str) -> None:
    """2048 seeded, scattered records of the 1 GiB file through
    stream_segments into a pinned slab, checked on the card; then a gather
    closed mid-flight and an exact one after it on the same context."""
    cuda = torch.device("cuda")
    recs = np.random.default_rng(5).choice(GiB // RECORD, 2048, replace=False)
    el = ExtentList([Extent(path, int(r) * RECORD, RECORD) for r in recs])
    file = np.memmap(path, dtype=np.uint8, mode="r")
    want = torch.from_numpy(np.concatenate(
        [file[r * RECORD: (r + 1) * RECORD] for r in recs])).to(cuda)
    del file
    ctx = strom_torch.init(StromConfig.from_env(engine="auto"))
    slab = ctx.host_batch((el.size,), cuda)
    _drop_cache(path)
    t0 = time.perf_counter()
    g = ctx.stream_segments(el, [Segment(0, 0, el.size)], slab)
    ranges, polls = _drive(g)
    if g.finish() != el.size:
        raise AssertionError("stream: finish() counted the wrong bytes")
    dt = time.perf_counter() - t0
    _check_tiling(ranges, el.size, "stream")
    peak = g.inflight_peak
    got = ctx.put_host_batch(slab, cuda)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("stream: gathered bytes differ from the file")
    say("stream", engine=ctx.engine.stats()["engine"], records=len(recs),
        record_bytes=RECORD, bytes=el.size, chunks=len(ranges),
        s=f"{dt:.4f}", gbps=f"{el.size / dt / 1e9:.3f}", inflight_peak=peak,
        polls=polls, queue_depth=ctx.config.queue_depth, exact=True)
    # close mid-flight, then an exact gather on the same context
    _drop_cache(path)
    g2 = ctx.stream_segments(el, [Segment(0, 0, el.size)],
                             ctx.alloc_read_buffer(el, el.size))
    first = g2.poll(min_completions=1)
    g2.close()
    g2.close()
    if ctx.engine.in_flight() != 0:
        raise AssertionError("stream: ops in flight after close()")
    slab = ctx.host_batch((el.size,), cuda)
    g3 = ctx.stream_segments(el, [Segment(0, 0, el.size)], slab)
    ranges, _ = _drive(g3)
    g3.finish()
    _check_tiling(ranges, el.size, "stream after close")
    if not torch.equal(ctx.put_host_batch(slab, cuda), want):
        raise AssertionError("stream: the gather after close() differs")
    say("stream", check="close mid-flight, then a gather", closed_after_ranges=
        len(first), in_flight_after_close=0, next_gather_exact=True,
        stream_gathers=ctx.stats()["stream_gathers"])
    strom_torch.close()


# ----------------------------------------------------------------- resnet
def _write_predecoded(path: str, records: np.ndarray, labels: np.ndarray) -> None:
    """A predecoded shard straight in the format: records, labels, meta."""
    _write_file(path, records)
    np.save(path + LABELS_SUFFIX, labels)
    with open(path + META_SUFFIX, "w") as f:
        json.dump({"image_size": records.shape[1], "n": len(records)}, f)


def _train_steps(label: str, model, step, pipe, n_steps: int) -> dict:
    """The first call untimed (on a step with no graph yet the warm-up,
    then the capturing call, also untimed), then *n_steps* timed replays
    (next batch + step + the loss read back), each checked finite.
    Returns the steady step ms and the timed stalls."""
    B = None
    times, calls, steady, stalls0 = [], [], [], None
    while len(steady) < n_steps:
        i = len(times)
        t0 = time.perf_counter()
        imgs, lbls = next(pipe)
        B = imgs.shape[0]
        m = step(model, imgs, lbls)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        calls.append(step.last_call)
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"{label} step {i}: loss {loss}, grad_norm {norm}")
        timed = i > 0 and step.last_call == "replay"
        if timed:
            steady.append(times[-1])
        else:
            stalls0 = pipe.data_stall_steps
        say(label, step=i, call=step.last_call, loss=f"{loss:.5f}",
            grad_norm=f"{norm:.5f}", ms=f"{times[-1] * 1e3:.1f}", timed=timed)
    summary = _step_summary(step, times, calls, steady)
    say(label, **summary, step_ms_first=f"{times[0] * 1e3:.1f}",
        images_per_s=f"{B / statistics.mean(steady):.1f}", timed_steps=n_steps,
        data_stall_steps_timed=pipe.data_stall_steps - stalls0,
        data_stall_steps_all=pipe.data_stall_steps,
        max_memory_allocated_gib=f"{torch.cuda.max_memory_allocated() / GiB:.2f}")
    return {"step_ms_steady": statistics.mean(steady) * 1e3,
            "stalls_timed": pipe.data_stall_steps - stalls0}


def phase_resnet(workdir: str):
    """Predecoded shard → make_predecoded_vision_pipeline → ResNet-50 SGD.
    Returns (model, step) for phase 7 and the shard's path for phase 8."""
    cuda = torch.device("cuda")
    n, B = 2048, 128
    rng = np.random.default_rng(6)
    records = np.frombuffer(rng.bytes(n * RECORD), dtype=np.uint8).reshape(
        n, IMAGE, IMAGE, 3)
    labels = rng.integers(0, 1000, n, dtype=np.int32)
    pdec = os.path.join(workdir, "imagenet.pdec")
    _write_predecoded(pdec, records, labels)
    all_records = torch.from_numpy(records).to(cuda)
    ctx = strom_torch.init(StromConfig.from_env())
    say("resnet", shard=os.path.basename(pdec), records=n,
        shard_bytes=records.nbytes, batch=B, image_size=IMAGE,
        engine=ctx.engine.stats()["engine"], o_direct=ctx.uses_o_direct(pdec))

    pipe = make_predecoded_vision_pipeline(ctx, [pdec], batch=B,
                                           image_size=IMAGE, device=cuda)
    order = iter(EpochShuffleSampler(n, B, seed=0))
    imgs, lbls = next(pipe)
    idx = next(order)
    if imgs.shape != (B, IMAGE, IMAGE, 3) or imgs.device.type != "cuda" \
            or not torch.equal(imgs, all_records[torch.from_numpy(idx).to(cuda)]) \
            or not torch.equal(lbls.cpu(), torch.from_numpy(labels[idx])):
        raise AssertionError("resnet: the first batch differs from the "
                             "sampler's records or labels")
    say("resnet", check="first batch equals the sampler's records and labels",
        exact=True)
    t0 = time.perf_counter()
    for _ in range(8):
        imgs, lbls = next(pipe)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    say("resnet", loader="predecoded alone", batches=8,
        images_per_s=f"{8 * B / dt:.1f}",
        gbps=f"{8 * B * RECORD / dt / 1e9:.3f}",
        data_stall_steps=pipe.data_stall_steps)
    pipe.close()
    del all_records

    cfg = ResNetConfig.resnet50()
    model = ResNet(cfg, device=cuda)
    step = make_resnet_sgd_step(cfg, device=cuda)
    say("resnet", config="resnet50", stages=cfg.stages, width=cfg.width,
        classes=cfg.num_classes, dtype=cfg.dtype,
        params=sum(p.numel() for p in model.parameters()))
    _drop_cache(pdec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = make_predecoded_vision_pipeline(ctx, [pdec], batch=B,
                                           image_size=IMAGE, device=cuda)
    _train_steps("resnet", model, step, pipe, 8)
    profile_step(lambda m, b: (m, step(m, *b)), model, next(pipe))
    pipe.close()
    strom_torch.close()
    _captured_equals_eager(
        "resnet", lambda: make_resnet_sgd_step(cfg, device=cuda),
        lambda: ResNet(cfg, device=cuda), _vision_call, _vision_batches(B, 3),
        lambda m: {k: m.state_dict()[k] for k in (
            "stem.conv", "stem.bn.scale", "stem.bn.mean", "stem.bn.var",
            "stage3.2.conv3", "stage3.2.bn3.var", "head.w", "head.b")})
    return model, step, pdec


def _vision_batches(B: int, n: int) -> list:
    """n seeded batches of B uint8 224² images and int32 labels, on the
    card."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    return [(torch.randint(0, 256, (B, IMAGE, IMAGE, 3), generator=gen,
                           device="cuda", dtype=torch.uint8),
             torch.randint(0, 1000, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)) for _ in range(n)]


def _vision_call(fn, model, batch) -> dict:
    return fn(model, *batch)


def _jpeg_fixture(path: str, n: int, side: int) -> None:
    """A WebDataset tar of n seeded side×side noise JPEGs (quality 90) with
    ASCII class labels, as strom/cli.py's bench fixture makes it."""
    import io
    import tarfile

    rng = np.random.default_rng(0)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
            if jpeg._HAVE_CV2:
                ok, buf = jpeg.cv2.imencode(".jpg", img,
                                            [jpeg.cv2.IMWRITE_JPEG_QUALITY, 90])
                if not ok:
                    raise AssertionError("cv2 could not encode the fixture")
                data = buf.tobytes()
            else:
                out = io.BytesIO()
                jpeg.Image.fromarray(img).save(out, format="JPEG", quality=90)
                data = out.getvalue()
            for name, payload in ((f"s{i:06d}.jpg", data),
                                  (f"s{i:06d}.cls", str(i % 1000).encode())):
                info = tarfile.TarInfo(name)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    _drop_cache(path)


def phase_resnet_jpeg(workdir: str, model, step) -> str | None:
    """JPEG WebDataset → make_imagenet_resnet_pipeline, streamed and not,
    then ResNet-50 steps fed by the streamed pipeline; skipped, saying
    what is missing, where the host has no JPEG encoder and resize.
    Returns the tar's path for phase 8 (None when skipped)."""
    native = jpeg.native_available()
    so = core_build.ensure_built()
    say("decode", native_libjpeg_turbo=native,
        native_built_with_jpeg=core_build.built_with_jpeg(so),
        cv2=jpeg._HAVE_CV2, PIL=jpeg._HAVE_PIL)
    if not (jpeg._HAVE_CV2 or jpeg._HAVE_PIL):
        say("resnet_jpeg", skipped=NO_JPEG)
        return None
    cuda = torch.device("cuda")
    tar = os.path.join(workdir, "imagenet.tar")
    t0 = time.perf_counter()
    _jpeg_fixture(tar, 512, 448)
    say("resnet_jpeg", fixture_samples=512, side=448, quality=90,
        tar_bytes=os.path.getsize(tar), fixture_s=f"{time.perf_counter() - t0:.2f}")
    ctx = strom_torch.init(StromConfig.from_env())
    runs = {}
    for stream in (True, False):
        _drop_cache(tar)
        pipe = make_imagenet_resnet_pipeline(ctx, [tar], batch=128, device=cuda,
                                             stream_intra_batch=stream)
        t0 = time.perf_counter()
        batches = [next(pipe) for _ in range(4)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = pipe.stats()
        pipe.close()
        runs[stream] = batches
        say("resnet_jpeg", streamed=stream, batches=4,
            images_per_s=f"{4 * 128 / dt:.1f}",
            stream_samples_early=st.get("stream_samples_early", 0),
            stream_batches=st.get("stream_batches", 0),
            decode_errors=st["decode_errors"],
            routes=json.dumps({k: v for k, v in st.items()
                               if k.endswith("_imgs") or "hits" in k},
                              sort_keys=True))
        if stream and st.get("stream_samples_early", 0) <= 0:
            raise AssertionError("resnet_jpeg: the streamed pipeline dispatched "
                                 "no sample while extents were in flight")
    for (a, la), (b, lb) in zip(runs[True], runs[False]):
        if not (torch.equal(a, b) and torch.equal(la, lb)):
            raise AssertionError("resnet_jpeg: streamed and barrier batches "
                                 "differ")
    say("resnet_jpeg", check="streamed and barrier batches bit-identical",
        batches=4, exact=True)
    _drop_cache(tar)
    pipe = make_imagenet_resnet_pipeline(ctx, [tar], batch=128, device=cuda)
    _train_steps("resnet_jpeg", model, step, pipe, 3)
    pipe.close()
    strom_torch.close()
    return tar


NO_JPEG = ("no_cv2_and_no_PIL:_neither_a_JPEG_encoder_for_the_fixture_nor_"
           "the_resize_of_the_train_transform")


# ------------------------------------------------ auto depth and caches
def phase_auto_depth(tar: str, model, step, steps: int = 16, *,
                     batch: int = 128, device: str = "cuda") -> None:
    """Phase 7b: the JPEG-fed ResNet pipeline at fixed prefetch depth 2 and
    with prefetch_auto (starting at 2), 1 warm-up and *steps* timed steps
    each: the depth trajectory, timed stalls and step ms per arm."""
    ctx = strom_torch.init(StromConfig.from_env())
    for arm, auto in (("fixed2", False), ("auto", True)):
        _drop_cache(tar)
        pipe = make_imagenet_resnet_pipeline(ctx, [tar], batch=batch,
                                             device=torch.device(device),
                                             prefetch_depth=2,
                                             auto_prefetch=auto)
        res = _train_steps(f"auto_depth_{arm}", model, step, pipe, steps)
        trace = pipe.prefetch_depth_trace
        st = pipe.stats()
        pipe.close()
        say("auto_depth", arm=arm, prefetch_auto=auto,
            depth_start=trace[0][1], depth_max=max(d for _, d in trace),
            depth_end=st["prefetch_depth"],
            grows=st.get("prefetch_depth_grow", 0),
            shrinks=st.get("prefetch_depth_shrink", 0),
            trace=json.dumps(trace).replace(" ", ""),
            stalls_timed=res["stalls_timed"],
            step_ms_steady=f"{res['step_ms_steady']:.2f}", timed_steps=steps)
        if not auto and len(trace) != 1:
            raise AssertionError(f"fixed depth moved: {trace}")
    strom_torch.close()


def _cache_counts(ctx: StromContext) -> dict:
    c = ctx.stats().get("cache", {})
    return {"cache_hit_bytes": c.get("cache_hit_bytes", 0),
            "cache_miss_bytes": c.get("cache_miss_bytes", 0),
            "cache_admitted_bytes": c.get("cache_admitted_bytes", 0),
            "readahead_bytes": c.get("cache_readahead_bytes", 0),
            "engine_bytes": ctx.engine.stats().get("bytes_read", 0)}


def _same_batches(label: str, got: list, want: list) -> None:
    for i, ((gi, gl), (wi, wl)) in enumerate(zip(got, want)):
        if not (torch.equal(gi, wi) and torch.equal(gl, wl)):
            raise AssertionError(f"{label}: batch {i} differs from the "
                                 f"uncached pipeline's")


def _spread(label: str, rates: list[list[float]], **kv) -> None:
    """One line per epoch: median, min and max of its images/s over the
    passes."""
    for e, rs in enumerate(rates):
        say(label, epoch=e, passes=len(rs), **kv,
            images_per_s_median=f"{statistics.median(rs):.1f}",
            images_per_s_min=f"{min(rs):.1f}", images_per_s_max=f"{max(rs):.1f}")


def phase_cache(pdec: str, *, batch: int = 128, epochs: int = 3,
                passes: int = 3, device: str = "cuda") -> None:
    """Phase 7c: the predecoded shard through make_predecoded_vision_pipeline
    with hot_cache_bytes 512 MiB and readahead_window_batches 4 (admission
    second_touch), *epochs* epochs, *passes* times over, each pass on a
    fresh context: per epoch the loader-alone images/s and the cache's, the
    engine's and the readahead's bytes (read between epochs, while the
    prefetcher already holds the next epoch's first batches); every batch
    equal to the uncached pipeline's, byte for byte; the last epoch must be
    served from the cache. Then each epoch's images/s over the passes."""
    dev = torch.device(device)
    image = IMAGE
    n = PredecodedShardSet((pdec,), image).num_records
    bpe = n // batch
    off = StromContext(StromConfig.from_env())
    with make_predecoded_vision_pipeline(off, [pdec], batch=batch,
                                         image_size=image, device=dev) as p:
        want = [next(p) for _ in range(epochs * bpe)]
    off.close()
    epoch_bytes = bpe * batch * image * image * 3
    rates: list[list[float]] = [[] for _ in range(epochs)]
    for r in range(passes):
        _drop_cache(pdec)
        ctx = StromContext(StromConfig.from_env(hot_cache_bytes=512 * MiB,
                                                readahead_window_batches=4))
        if r == 0:
            say("cache", shard=os.path.basename(pdec), records=n, batch=batch,
                hot_cache_bytes=ctx.config.hot_cache_bytes,
                admit=ctx.config.hot_cache_admit,
                readahead_window_batches=ctx.config.readahead_window_batches)
        pipe = make_predecoded_vision_pipeline(ctx, [pdec], batch=batch,
                                               image_size=image, device=dev)
        try:
            for e in range(epochs):
                before = _cache_counts(ctx)
                t0 = time.perf_counter()
                got = [next(pipe) for _ in range(bpe)]
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                delta = {k: v - before[k] for k, v in _cache_counts(ctx).items()}
                _same_batches(f"cache pass {r} epoch {e}", got,
                              want[e * bpe:(e + 1) * bpe])
                rates[e].append(bpe * batch / dt)
                say("cache", run=r, epoch=e, loader="alone", batches=bpe,
                    images_per_s=f"{rates[e][-1]:.1f}",
                    hit_share=f"{delta['cache_hit_bytes'] / epoch_bytes:.3f}",
                    exact=True, **delta)
            if delta["cache_hit_bytes"] <= 0:
                raise AssertionError("cache: the last epoch was not served "
                                     "from the cache")
            if r == passes - 1:
                say("cache", stats=json.dumps(ctx.stats()["cache"],
                                              sort_keys=True),
                    data_stall_steps=pipe.data_stall_steps)
        finally:
            pipe.close()
            ctx.close()
    _spread("cache", rates, loader="alone")


def _epoch(label: str, pipe, bpe: int, model, step, train: bool):
    """*bpe* batches of *pipe*, each followed, where *train*, by a ResNet
    step whose loss is read back; per batch the ms of next + step +
    synchronize. Returns (batches, per-batch seconds, total seconds)."""
    got, times = [], []
    t0 = time.perf_counter()
    for _ in range(bpe):
        ts = time.perf_counter()
        imgs, lbls = next(pipe)
        got.append((imgs, lbls))
        if train:
            loss = step(model, imgs, lbls)["loss"].item()
            if not math.isfinite(loss):
                raise AssertionError(f"{label}: loss {loss}")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    return got, times, time.perf_counter() - t0


def _step_ms(times: list[float]) -> dict:
    return {"resnet_step_ms_mean": f"{statistics.mean(times) * 1e3:.2f}",
            "resnet_step_ms_median": f"{statistics.median(times) * 1e3:.2f}"}


def phase_decoded_cache(tar: str | None, model, step, *, batch: int = 128,
                        epochs: int = 4, passes: int = 3,
                        device: str = "cuda") -> None:
    """Phase 7d: the JPEG tar through make_imagenet_resnet_pipeline with
    full-resolution decode (decode_reduced_scale=False: cached frames are
    full decodes), first uncached, then *passes* times with hot_cache_bytes
    1 GiB and decode_cache on (admission second_touch, so the third epoch
    is the first served from the cache), each pass on a fresh context. In
    every arm the third epoch feeds ResNet-50 steps, timed per batch (next
    + step + synchronize) in the same loop, the other epochs run the loader
    alone. Per epoch the images/s and the decoded cache's hits and
    plan-time hits; every batch equal to the uncached pipeline's; then each
    epoch's images/s over the passes."""
    if tar is None:
        say("decoded_cache", skipped=NO_JPEG)
        return
    dev = torch.device(device)
    kw = dict(batch=batch, device=dev, decode_reduced_scale=False)
    off = StromContext(StromConfig.from_env())
    want = []
    with make_imagenet_resnet_pipeline(off, [tar], **kw) as p:
        bpe = p.sampler.batches_per_epoch
        n = p.sampler.num_records
        for e in range(epochs):
            train = e == 2
            got, times, dt = _epoch("decoded_cache uncached", p, bpe, model,
                                    step, train)
            want.extend(got)
            say("decoded_cache", arm="uncached", epoch=e, batches=bpe,
                images_per_s=f"{bpe * batch / dt:.1f}",
                **(_step_ms(times) if train else {"loader": "alone"}))
    off.close()
    keys = ("decode_cache_hits", "decode_cache_misses",
            "decode_cache_plan_hits", "decode_cache_admitted_bytes")
    rates: list[list[float]] = [[] for _ in range(epochs)]
    for r in range(passes):
        _drop_cache(tar)
        ctx = StromContext(StromConfig.from_env(hot_cache_bytes=GiB))
        if r == 0:
            say("decoded_cache", samples=n, batch=batch,
                hot_cache_bytes=ctx.config.hot_cache_bytes,
                admit=ctx.config.hot_cache_admit, decode_reduced_scale=False)
        pipe = make_imagenet_resnet_pipeline(ctx, [tar], decode_cache=True,
                                             **kw)
        try:
            for e in range(epochs):
                before = {k: pipe.stats().get(k, 0) for k in keys}
                stalls0 = pipe.data_stall_steps
                train = e == 2
                got, times, dt = _epoch("decoded_cache", pipe, bpe, model,
                                        step, train)
                delta = {k: pipe.stats().get(k, 0) - before[k] for k in keys}
                _same_batches(f"decoded_cache pass {r} epoch {e}", got,
                              want[e * bpe:(e + 1) * bpe])
                rates[e].append(bpe * batch / dt)
                extra = ({**_step_ms(times),
                          "data_stall_steps": pipe.data_stall_steps - stalls0}
                         if train else {"loader": "alone"})
                say("decoded_cache", arm="cached", run=r, epoch=e,
                    batches=bpe, images_per_s=f"{rates[e][-1]:.1f}",
                    exact=True, **delta, **extra)
                if train and delta["decode_cache_plan_hits"] <= 0:
                    raise AssertionError("decoded_cache: the third epoch "
                                         "found no frame in the cache")
            if r == passes - 1:
                say("decoded_cache", stats=json.dumps(
                    ctx.stats()["decode_cache"], sort_keys=True))
        finally:
            pipe.close()
            ctx.close()
    _spread("decoded_cache", rates, arm="cached",
            note="the third epoch's rate includes its ResNet steps")


# -------------------------------------------------------------------- vit
def _stripe_members(src: str, n: int, chunk: int) -> list[str]:
    """*src* striped RAID0 over n member files beside it, on disk and out
    of the page cache."""
    members = [f"{src}.m{i}" for i in range(n)]
    if stripe_file(src, members, chunk) != os.path.getsize(src):
        raise AssertionError(f"stripe_file lost bytes of {src}")
    for m in members:
        fd = os.open(m, os.O_RDWR)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        _drop_cache(m)
    return members


def _loader_alone(label: str, pipe, batches: int, B: int) -> None:
    t0 = time.perf_counter()
    for _ in range(batches):
        next(pipe)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    say(label, loader="alone", batches=batches,
        images_per_s=f"{batches * B / dt:.1f}",
        data_stall_steps=pipe.data_stall_steps)


def phase_vit(pdec: str, tar: str | None) -> None:
    """BASELINE config #3: ViT-B/16 (bf16, batch 64) fed from a RAID0 set
    of 4 members: phase 6's predecoded shard staged striped, then, where
    phase 7 made it, the JPEG tar striped through make_vit_wds_pipeline."""
    cuda = torch.device("cuda")
    B, chunk = 64, StromConfig().raid_chunk
    ctx = strom_torch.init(StromConfig.from_env())
    t0 = time.perf_counter()
    members = _stripe_members(pdec, 4, chunk)
    alias = stage_striped_predecoded(ctx, pdec, members, chunk, stripe=False)
    say("vit", shard=os.path.basename(alias), members=len(members),
        raid_chunk=chunk, stage_s=f"{time.perf_counter() - t0:.2f}",
        engine=ctx.engine.stats()["engine"])
    report_check("vit-striped-set", strom_torch.check_file(alias))

    records = np.memmap(pdec, dtype=np.uint8, mode="r").reshape(
        -1, IMAGE, IMAGE, 3)
    labels = np.load(pdec + LABELS_SUFFIX)
    pipe = make_predecoded_vision_pipeline(ctx, [alias], batch=B,
                                           image_size=IMAGE, device=cuda)
    idx = next(iter(EpochShuffleSampler(len(records), B, seed=0)))
    imgs, lbls = next(pipe)
    if imgs.shape != (B, IMAGE, IMAGE, 3) or not torch.equal(
            imgs.cpu(), torch.from_numpy(records[idx])) \
            or not torch.equal(lbls.cpu(), torch.from_numpy(labels[idx])):
        raise AssertionError("vit: the first striped batch differs from the "
                             "sampler's records or labels")
    say("vit", check="first striped batch equals the sampler's records and "
        "labels", exact=True)
    _loader_alone("vit", pipe, 8, B)
    pipe.close()
    del records

    cfg = ViTConfig.vit_b16()
    model = ViT(cfg, device=cuda,
                generator=torch.Generator(device=cuda).manual_seed(0))
    step = make_vit_sgd_step(cfg, device=cuda)
    say("vit", config="vit_b16", d_model=cfg.d_model, layers=cfg.n_layers,
        heads=cfg.n_heads, d_mlp=cfg.d_mlp, classes=cfg.num_classes,
        image_size=cfg.image_size, patch=cfg.patch, dtype=cfg.dtype,
        params=sum(p.numel() for p in model.parameters()), batch=B)
    for m in members:
        _drop_cache(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe = make_predecoded_vision_pipeline(ctx, [alias], batch=B,
                                           image_size=IMAGE, device=cuda)
    _train_steps("vit", model, step, pipe, 8)
    profile_step(lambda m, b: (m, step(m, *b)), model, next(pipe))
    pipe.close()
    _captured_equals_eager(
        "vit", lambda: make_vit_sgd_step(cfg, device=cuda),
        lambda: ViT(cfg, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0)),
        _vision_call, _vision_batches(B, 3),
        lambda m: {k: m.state_dict()[k] for k in (
            "patch_embed", "pos_embed", "layers.0.wqkv", "layers.11.w2",
            "final_ln.scale", "head.w")})

    if tar is None:
        say("vit_jpeg", skipped=NO_JPEG)
    else:
        members = _stripe_members(tar, 4, chunk)
        walias = tar + ".raid0"
        ctx.register_striped(walias, members, chunk, size=os.path.getsize(tar))
        report_check("vit-jpeg-striped-set", strom_torch.check_file(walias))
        pipe = make_vit_wds_pipeline(ctx, [walias], batch=B, image_size=IMAGE,
                                     device=cuda)
        _loader_alone("vit_jpeg", pipe, 4, B)
        say("vit_jpeg", scope=json.dumps(pipe.stats()["scope"]),
            stream_samples_early=pipe.stats().get("stream_samples_early", 0))
        pipe.close()
        for m in members:
            _drop_cache(m)
        pipe = make_vit_wds_pipeline(ctx, [walias], batch=B, image_size=IMAGE,
                                     device=cuda)
        _train_steps("vit_jpeg", model, step, pipe, 3)
        pipe.close()
    strom_torch.close()


# ---------------------------------------------------------------- parquet
PQ_SHARDS, PQ_ROWS, PQ_GROUP = 4, 2_097_152, 524_288
PQ_FEATURES = [f"f{i}" for i in range(16)]
PQ_WIDE = ["value"] + PQ_FEATURES            # 68 bytes a row selected
PQ_SELECTIVITY = 0.25
# the scan's prefetch threads: read and decode, pack, copy to the device
PQ_STAGES = ("parquet_scan_read_us", "parquet_scan_pack_us",
             "parquet_scan_put_us")


def _pq_shard_columns(shard: int) -> dict[str, np.ndarray]:
    """Shard *shard* of config #5's fixture, from its own seed: seq (a
    global arange, so every row group's min/max are disjoint), value and
    f0-f15 float32, payload int64: 84 bytes a row."""
    rng = np.random.default_rng(900 + shard)
    cols = {"seq": np.arange(shard * PQ_ROWS, (shard + 1) * PQ_ROWS,
                             dtype=np.int64),
            "value": rng.standard_normal(PQ_ROWS, dtype=np.float32)}
    for name in PQ_FEATURES:
        cols[name] = rng.standard_normal(PQ_ROWS, dtype=np.float32)
    cols["payload"] = rng.integers(0, 1 << 40, PQ_ROWS, dtype=np.int64)
    return cols


def _pq_fixture(workdir: str) -> tuple[list[str], dict]:
    """The four shards, written by the port's write_parquet, and numpy's
    answers over them (float64 sums)."""
    paths, ref = [], {"hits": 0, "fsum": 0.0, "fabs": 0.0, "shard0_hits": 0,
                      "shard0_fsum": 0.0}
    t0 = time.perf_counter()
    nbytes = 0
    wctx = StromContext(StromConfig.from_env())
    for s in range(PQ_SHARDS):
        cols = _pq_shard_columns(s)
        path = os.path.join(workdir, f"scan{s}.parquet")
        nbytes += write_parquet(wctx, path, cols, row_group_rows=PQ_GROUP)
        _drop_cache(path)
        hits = int(np.count_nonzero(cols["value"] > 0))
        fsum = float(sum(cols[c].sum(dtype=np.float64) for c in PQ_FEATURES))
        ref["hits"] += hits
        ref["fsum"] += fsum
        ref["fabs"] += float(sum(np.abs(cols[c]).sum(dtype=np.float64)
                                 for c in PQ_FEATURES))
        if s == 0:
            ref["shard0_hits"], ref["shard0_fsum"] = hits, fsum
        paths.append(path)
    wctx.close()
    say("parquet", fixture_shards=PQ_SHARDS, rows=PQ_SHARDS * PQ_ROWS,
        row_group_rows=PQ_GROUP, columns=2 + len(PQ_WIDE), bytes=nbytes,
        write_s=f"{time.perf_counter() - t0:.2f}")
    return paths, ref


def _pq_pyarrow_check(path: str, workdir: str) -> None:
    """Where pyarrow imports: it reads a shard of the port's writer equal to
    the written arrays, and the port reads a pyarrow-written PLAIN file
    equal to pyarrow's values."""
    version = pyarrow_version()
    say("parquet", pyarrow=version or "absent")
    if version is None:
        return
    import pyarrow as pa
    import pyarrow.parquet as pq

    want = _pq_shard_columns(0)
    table = pq.read_table(path)
    for name, arr in want.items():
        if not np.array_equal(table[name].to_numpy(), arr):
            raise AssertionError(f"parquet: pyarrow reads column {name} of "
                                 f"the port's file wrong")
    theirs = os.path.join(workdir, "pyarrow_plain.parquet")
    pq.write_table(pa.table({k: want[k][:200_000]
                             for k in ("seq", "value", "f0")}), theirs,
                   row_group_size=65_536, compression="NONE",
                   use_dictionary=False)
    ctx = StromContext(StromConfig.from_env())
    try:
        shard = ParquetShard(theirs, ctx=ctx)
        got = [shard.read_row_group_arrays(ctx, g, ["seq", "value", "f0"])
               for g in range(shard.num_row_groups)]
        if ctx.stats().get("parquet_decode_bytes", 0):
            raise AssertionError("parquet: pyarrow's PLAIN file left the "
                                 "PLAIN route")
    finally:
        ctx.close()
    ref = pq.read_table(theirs)
    for name in ("seq", "value", "f0"):
        if not np.array_equal(np.concatenate([g[name] for g in got]),
                              ref[name].to_numpy()):
            raise AssertionError(f"parquet: the port reads column {name} "
                                 f"of pyarrow's file wrong")
    os.unlink(theirs)
    say("parquet", check="pyarrow reads the port's shard and the port "
        "pyarrow's PLAIN file", exact=True)


def _pq_extents(paths: list[str], cols: list[str]) -> list:
    return [e for p in paths for s in [ParquetShard(p)]
            for g in range(s.num_row_groups)
            for e in s.column_chunk_extents(g, cols).extents]


def _bare_gather(cfg: StromConfig, extents: list, dest: np.ndarray) -> float:
    """Seconds for a bare engine (no planner, no decode, no device) to
    gather exactly *extents* into *dest*: the reference's --disk-rate
    yardstick. Column chunks start unaligned, so the ops take the engine's
    buffered route, as the scan's own gathers do."""
    eng = make_engine(cfg)
    try:
        fis = {p: eng.register_file(p) for p in {e.path for e in extents}}
        ops, off = [], 0
        for e in extents:
            ops.append((fis[e.path], e.offset, off, e.length))
            off += e.length
        t0 = time.perf_counter()
        n = eng.read_vectored(ops, dest)
        dt = time.perf_counter() - t0
    finally:
        eng.close()
    if n != off:
        raise AssertionError(f"parquet: the bare gather read {n} of {off} "
                             f"bytes")
    return dt


def _pq_arm(label: str, ctx, paths: list[str], cols: list[str], scan,
            check) -> dict:
    """Two cold passes of *scan* alternating with two of the bare gather of
    the same extents, best of each: rows/s, selected GB/s, the gather's
    GB/s, vs_disk, host CPU s per GiB, PLAIN and pyarrow bytes, stalls."""
    extents = _pq_extents(paths, cols)
    selected = sum(e.length for e in extents)
    dest = alloc_aligned(selected, populate=True)
    scans, raws, cpus = [], [], []
    st0 = ctx.stats()
    for i in range(2):
        for arm in (("scan", "raw") if i % 2 == 0 else ("raw", "scan")):
            for p in paths:
                _drop_cache(p)
            if arm == "raw":
                raws.append(_bare_gather(ctx.config, extents, dest))
                continue
            cpu0, t0 = _cpu_s(), time.perf_counter()
            out = scan()
            scans.append(time.perf_counter() - t0)
            cpus.append(_cpu_s() - cpu0)
            check(out)
    st1 = ctx.stats()
    delta = {k: st1.get(k, 0) - st0.get(k, 0) for k in (
        "parquet_plain_bytes", "parquet_decode_bytes",
        "parquet_scan_units", "parquet_scan_data_stalls") + PQ_STAGES}
    best = min(range(2), key=lambda i: scans[i])
    res = {"rows_per_s": PQ_SHARDS * PQ_ROWS / scans[best],
           "selected_gbps": selected / scans[best] / 1e9,
           "disk_gbps": selected / min(raws) / 1e9,
           "cpu_s_per_gib": cpus[best] / (selected / GiB)}
    res["vs_disk"] = res["selected_gbps"] / res["disk_gbps"]
    say("parquet", arm=label, columns=len(cols), selected_bytes=selected,
        rows_per_s=f"{res['rows_per_s']:.1f}",
        selected_gbps=f"{res['selected_gbps']:.3f}",
        disk_gbps=f"{res['disk_gbps']:.3f}", vs_disk=f"{res['vs_disk']:.3f}",
        cpu_s_per_gib=f"{res['cpu_s_per_gib']:.4f}",
        scan_s=",".join(f"{t:.4f}" for t in scans),
        disk_s=",".join(f"{t:.4f}" for t in raws), **delta)
    if delta["parquet_decode_bytes"] != 0 or delta["parquet_plain_bytes"] \
            != 2 * selected:
        raise AssertionError(f"parquet {label}: not every byte rode the PLAIN "
                             f"route: {delta}")
    return res


def _pq_stages(ctx, paths: list[str], cols: list[str], scan_at) -> None:
    """Where a cold wide scan's time goes: the same per-unit gathers alone,
    serial, into a fresh buffer each (as the scan's reads land) and into
    one reused prefaulted buffer; then the whole scan at prefetch depth 1
    and 4 beside the default 2."""
    els = [s.column_chunk_extents(g, cols) for p in paths
           for s in [ParquetShard(p)] for g in range(s.num_row_groups)]
    buf = alloc_aligned(max(el.size for el in els), populate=True)
    secs, stages = {}, {}
    for label in ("gathers_fresh", "gathers_reused", "depth1", "depth4"):
        for p in paths:
            _drop_cache(p)
        st0 = ctx.stats()
        t0 = time.perf_counter()
        if label == "gathers_fresh":
            for el in els:
                ctx.pread(el)
        elif label == "gathers_reused":
            for el in els:
                ctx.memcpy_ssd2host(el, out=buf)
        else:
            scan_at(int(label[-1]))
        secs[label] = time.perf_counter() - t0
        st1 = ctx.stats()
        stages.update({f"{label}_{k[13:]}": st1.get(k, 0) - st0.get(k, 0)
                       for k in PQ_STAGES if label.startswith("depth")})
    say("parquet", arm="wide_stages", units=len(els),
        **{f"{k}_s": f"{v:.4f}" for k, v in secs.items()}, **stages)


def _profile_scan(scan) -> None:
    """One wide scan under torch.profiler: device busy ms (the union of
    kernel and copy intervals) and the device's idle share of the scan's
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        scan()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_PAD_S)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    kernels = [sp for sp in spans if _kernel_group(sp[2]) != "memcpy/memset"]
    if not kernels:
        say("parquet", profile="not measured", device_events=len(spans),
            note="the profiler recorded no kernel of the scan")
        return
    busy, reach, copy_us = 0.0, -math.inf, 0.0
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        if _kernel_group(name) == "memcpy/memset":
            copy_us += end - start
    say("parquet", profile="wide", device_kernels=len(kernels),
        scan_ms=f"{wall_us / 1e3:.1f}", device_busy_ms=f"{busy / 1e3:.2f}",
        device_idle_share=f"{1 - busy / wall_us:.3f}",
        copy_ms=f"{copy_us / 1e3:.2f}",
        kernel_ms=f"{sum(e - s for s, e, _ in kernels) / 1e3:.2f}")


def phase_parquet(workdir: str, tar: str | None) -> tuple[list[str], int]:
    """BASELINE config #5 on one H100: the port's PLAIN shards scanned
    into device aggregates, narrow and wide, cold, beside a bare gather of
    the same extents; the pushdown A/B; a striped shard; the OpGraph.
    Returns the shards' paths and the narrow count for phase 10."""
    cuda = torch.device("cuda")
    paths, ref = _pq_fixture(workdir)
    _pq_pyarrow_check(paths[0], workdir)
    ctx = StromContext(StromConfig.from_env())

    def on_card(v: torch.Tensor) -> torch.Tensor:
        if not v.is_cuda:
            raise AssertionError("parquet: map_fn got a host tensor")
        return v > 0

    def wide_map(c: dict) -> dict:
        if not all(c[n].is_cuda for n in PQ_WIDE):
            raise AssertionError("parquet: map_fn got a host tensor")
        return {"hits": (c["value"] > 0).sum(),
                "fsum": torch.stack([c[n].sum() for n in PQ_FEATURES]).sum()}

    def narrow(p=paths):
        return parquet_count_where(ctx, p, "value", on_card)

    def wide(p=paths, depth=2):
        return parquet_scan_aggregate(ctx, p, PQ_WIDE, wide_map,
                                      prefetch_depth=depth)

    # float32 sums of 2^27 terms in another order than numpy's float64: a
    # pairwise sum's error bound, log2(terms) x 2^-24 x sum|x|
    fsum_tol = 27 * 2.0 ** -24 * ref["fabs"]

    def check_narrow(got: int) -> None:
        if got != ref["hits"]:
            raise AssertionError(f"parquet narrow: {got} != {ref['hits']}")

    def check_wide(out: dict) -> None:
        if int(out["hits"]) != ref["hits"] \
                or abs(float(out["fsum"]) - ref["fsum"]) > fsum_tol:
            raise AssertionError(f"parquet wide: {out} against hits "
                                 f"{ref['hits']}, fsum {ref['fsum']} "
                                 f"(tolerance {fsum_tol:.3f})")

    say("parquet", engine=ctx.engine.stats()["engine"], prefetch_depth=2,
        unit_batch=1, units=PQ_SHARDS * PQ_ROWS // PQ_GROUP)
    _pq_arm("narrow", ctx, paths, ["value"], narrow, check_narrow)
    _pq_arm("wide", ctx, paths, PQ_WIDE, wide, check_wide)
    out = wide()
    say("parquet", check="counts against numpy", narrow_hits=ref["hits"],
        wide_hits=int(out["hits"]), fsum=f"{float(out['fsum']):.4f}",
        fsum_numpy_f64=f"{ref['fsum']:.4f}",
        fsum_err=f"{abs(float(out['fsum']) - ref['fsum']):.4f}",
        fsum_tolerance=f"{fsum_tol:.3f}", exact_counts=True)
    _pq_stages(ctx, paths, PQ_WIDE, lambda d: check_wide(wide(depth=d)))
    for p in paths:
        _drop_cache(p)
    _profile_scan(wide)

    # pushdown: the reference's A/B at selectivity 0.25 over seq < cutoff
    cutoff = int(PQ_SHARDS * PQ_ROWS * PQ_SELECTIVITY)

    def pushed():
        return parquet_scan_aggregate(
            ctx, paths, ["value"], lambda c: {"hits": (c["value"] > 0).sum()},
            predicate=col("seq") < cutoff)

    def post():
        return parquet_scan_aggregate(
            ctx, paths, ["value", "seq"],
            lambda c: {"hits": ((c["value"] > 0)
                                & (c["seq"] < cutoff)).sum()})

    rates, hits, d = {}, {}, {}
    for label, fn in (("pushed", pushed), ("post_hoc", post)):
        for p in paths:
            _drop_cache(p)
        st0 = ctx.stats()
        t0 = time.perf_counter()
        hits[label] = int(fn()["hits"])
        rates[label] = PQ_SHARDS * PQ_ROWS / (time.perf_counter() - t0)
        if label == "pushed":
            st1 = ctx.stats()
            d = {k: st1.get(k, 0) - st0.get(k, 0) for k in PUSHDOWN_FIELDS}
    unpushed = d["parquet_pushdown_skipped_bytes"] \
        + d["parquet_pushdown_submitted_bytes"]
    say("parquet", arm="pushdown", selectivity=PQ_SELECTIVITY, cutoff=cutoff,
        groups_refuted=f"{d['parquet_pushdown_groups_skipped']}/"
                       f"{d['parquet_pushdown_groups_total']}",
        skipped_bytes=d["parquet_pushdown_skipped_bytes"],
        submitted_bytes=d["parquet_pushdown_submitted_bytes"],
        submitted_share=f"{d['parquet_pushdown_submitted_bytes'] / unpushed:.4f}",
        rows_masked=d["parquet_pushdown_rows_masked"],
        pushed_rows_per_s=f"{rates['pushed']:.1f}",
        post_hoc_rows_per_s=f"{rates['post_hoc']:.1f}",
        hits=hits["pushed"], post_hoc_hits=hits["post_hoc"])
    if hits["pushed"] != hits["post_hoc"] or hits["pushed"] != \
            ref["shard0_hits"] or d["parquet_pushdown_skipped_bytes"] <= 0 \
            or d["parquet_pushdown_submitted_bytes"] >= unpushed:
        raise AssertionError(f"parquet pushdown: hits {hits} (numpy "
                             f"{ref['shard0_hits']}), counters {d}")

    # striped: shard 0 over 4 members in raid_chunk pieces, behind an alias
    chunk = StromConfig().raid_chunk
    members = _stripe_members(paths[0], 4, chunk)
    alias = paths[0] + ".raid0"
    ctx.register_striped(alias, members, chunk,
                         size=os.path.getsize(paths[0]))
    plain_n, striped_n = narrow([paths[0]]), narrow([alias])
    plain_w, striped_w = wide([paths[0]]), wide([alias])
    say("parquet", arm="striped", members=4, raid_chunk=chunk,
        narrow_hits=striped_n, wide_hits=int(striped_w["hits"]),
        fsum=f"{float(striped_w['fsum']):.4f}")
    if not (plain_n == striped_n == ref["shard0_hits"]
            and int(plain_w["hits"]) == int(striped_w["hits"])
            and plain_w["fsum"].tobytes() == striped_w["fsum"].tobytes()):
        raise AssertionError(f"parquet striped: {striped_n}, {striped_w} "
                             f"against the plain shard's {plain_n}, "
                             f"{plain_w}")
    for m in members:
        os.unlink(m)
    os.unlink(members[0] + ".stromsz")
    ctx.close()

    if tar is None:
        say("parquet", opgraph="skipped=" + NO_JPEG)
        return paths, ref["hits"]
    # the reference test's graph on phase 7's tar: fused and streamed
    # against unfused, batches bit-equal
    runs = {}
    for fuse in (True, False):
        gctx = StromContext(StromConfig.from_env())
        graph = (OpGraph().filter(lambda x: x[0, 0, 0] < 250)
                 .project(slice(0, 24), slice(0, 24))
                 .normalize([127.5] * 3, [63.0] * 3).cast(np.float32))
        pipe = make_wds_vision_pipeline(gctx, [tar], batch=64,
                                        image_size=IMAGE, device=cuda,
                                        seed=11, opgraph=graph,
                                        opgraph_fuse=fuse,
                                        stream_intra_batch=fuse)
        runs[fuse] = [next(pipe) for _ in range(3)]
        pipe.close()
        ops = {k: v for k, v in gctx.stats().items() if k.startswith("ops_")}
        gctx.close()
        say("parquet", opgraph="fused" if fuse else "unfused", batches=3,
            shape=tuple(runs[fuse][0][0].shape),
            dtype=str(runs[fuse][0][0].dtype), **ops)
    for (a, la), (b, lb) in zip(runs[True], runs[False]):
        if a.dtype != torch.float32 or a.shape != (64, 24, 24, 3) \
                or not (torch.equal(a, b) and torch.equal(la, lb)):
            raise AssertionError("parquet opgraph: fused and unfused batches "
                                 "differ")
    say("parquet", opgraph="fused and streamed against unfused",
        exact=True)
    return paths, ref["hits"]


# ------------------------------------------------------- spill (7e)
SPILL_RECORD_TOKENS = 1024           # the reference arm's records: 4 KiB
SPILL_STEP = 32                      # records a pread


def _spill_counts(ctx: StromContext) -> dict:
    st = ctx.stats()
    sp = st.get("spill", {})
    out = {k: sp.get(k, 0) for k in SPILL_FIELDS if k in sp}
    out["spill_errors"] = sp.get("spill_errors", 0)
    out["spill_comp_ratio"] = sp.get("spill_comp_ratio", 0.0)
    out["cache_miss_bytes"] = st["cache"]["cache_miss_bytes"]
    out["engine_bytes"] = ctx.engine.stats().get("bytes_read", 0)
    # per-op engine latency: source reads run as the default tenant (the
    # context's scope), spill I/O as the tenant "spill"
    none = [0] * 24
    out["hist"] = {
        "source": ctx.scope.snapshot().get("engine_op_lat_hist", none),
        "spill": ctx.scheduler.tenant("spill").scope.snapshot().get(
            "engine_op_lat_hist", none)}
    return out


def _spill_epoch_line(arm: str, epoch: int, before: dict, after: dict,
                      **kv) -> int:
    """Print one epoch's spill fields (counters as deltas, occupancy and
    ratios as read); returns the epoch's source misses."""
    gauges = ("spill_entries", "spill_bytes", "spill_hit_ratio",
              "spill_comp_ratio")
    for k, h in after["hist"].items():
        d = [a - b for a, b in zip(h, before["hist"][k])]
        kv[f"{k}_op_lat_p50_us"] = percentile_from_buckets(d, 0.50)
        kv[f"{k}_op_lat_p99_us"] = percentile_from_buckets(d, 0.99)
        kv[f"{k}_ops"] = sum(d)
    delta = {k: (after[k] if k in gauges else after[k] - before[k])
             for k in after if k != "hist"}
    miss = delta.pop("cache_miss_bytes")
    say("spill", arm=arm, epoch=epoch, spill_cache_miss_bytes=miss,
        cache_miss_bytes=miss, **kv, **delta)
    return miss


def _spill_pread_arm(workdir: str, toks: np.ndarray, compress: bool) -> None:
    """The reference's spill epoch pair (at 1 GiB of *toks*): the token
    shard written through the context, a hot cache of 1/8 of it with
    admission "always", a spill file of twice it, 32 records a pread, two
    epochs, every read checked against the tokens; the second epoch must
    miss nothing."""
    sdir = os.path.join(workdir, "spill")
    ctx = StromContext(StromConfig.from_env(
        hot_cache_bytes=toks.nbytes // 8, hot_cache_admit="always",
        spill_bytes=2 * toks.nbytes, spill_dir=sdir,
        spill_compress=compress),
        scope={"phase": f"spill-pread-{compress}"})
    path = os.path.join(workdir, "spill_tokens.bin")
    try:
        write_token_shard(ctx, path, toks)
        _drop_cache(path)
        ss = TokenShardSet((path,), record_tokens=SPILL_RECORD_TOKENS)
        rec = ss.record_bytes
        flat = toks.view(np.uint8)
        codec = default_codec()
        say("spill", arm="pread", compress=compress,
            codec=(codec.name if codec is not None else "none"),
            bytes=toks.nbytes, records=ss.num_records, record_bytes=rec,
            records_per_pread=SPILL_STEP,
            hot_cache_bytes=ctx.config.hot_cache_bytes,
            admit=ctx.config.hot_cache_admit,
            spill_bytes=ctx.config.spill_bytes,
            spill_engine_io=ctx.config.spill_engine_io,
            engine=ctx.engine.stats()["engine"])
        misses = []
        for epoch in range(2):
            before = _spill_counts(ctx)
            cpu0, t0 = _cpu_s(), time.perf_counter()
            for lo in range(0, ss.num_records - SPILL_STEP + 1, SPILL_STEP):
                got = ctx.pread(ss.extents(range(lo, lo + SPILL_STEP)))
                if not np.array_equal(got, flat[lo * rec:
                                                (lo + SPILL_STEP) * rec]):
                    raise AssertionError(f"spill pread: records {lo}+"
                                         f"{SPILL_STEP} differ from the "
                                         f"shard in epoch {epoch}")
            dt, cpu = time.perf_counter() - t0, _cpu_s() - cpu0
            misses.append(_spill_epoch_line(
                "pread", epoch, before, _spill_counts(ctx),
                compress=compress, s=f"{dt:.3f}",
                mb_per_s=f"{toks.nbytes / dt / 1e6:.1f}",
                cpu_s_per_gib=f"{cpu / (toks.nbytes / GiB):.3f}",
                exact=True))
        st = _spill_counts(ctx)
        if misses[1] != 0 or st["spill_hit_bytes"] <= 0 \
                or st["spill_errors"]:
            raise AssertionError(f"spill pread: epoch 2 missed {misses[1]} "
                                 f"bytes to the source: {st}")
    finally:
        ctx.close()
        if os.path.exists(path):
            os.unlink(path)
    if os.path.isdir(sdir) and os.listdir(sdir):
        raise AssertionError(f"spill: the spill file outlived its context: "
                             f"{os.listdir(sdir)}")


def _spill_resnet_run(pdec: str, cfg: StromConfig, epochs: int, B: int,
                      cached: bool) -> tuple[list, list, list]:
    """*epochs* epochs of the predecoded shard into a fresh ResNet-50's
    captured SGD step (one pipeline an epoch from its SamplerState, depth
    1, so no read crosses an epoch). Returns the batches, the losses and
    each epoch's counters."""
    cuda = torch.device("cuda")
    rcfg = ResNetConfig.resnet50()
    model = ResNet(rcfg, device=cuda)
    step = make_resnet_sgd_step(rcfg, device=cuda)
    n = PredecodedShardSet((pdec,), IMAGE).num_records
    bpe = n // B
    ctx = StromContext(cfg, scope={"phase": f"spill-resnet-{cached}"})
    batches, losses, counts = [], [], []
    _drop_cache(pdec)
    try:
        for e in range(epochs):
            before = _spill_counts(ctx) if cached else {}
            pipe = make_predecoded_vision_pipeline(
                ctx, [pdec], batch=B, image_size=IMAGE, device=cuda,
                prefetch_depth=1,
                resume_from=SamplerState(epoch=e, batch_in_epoch=0, seed=0))
            t0 = time.perf_counter()
            try:
                for _ in range(bpe):
                    imgs, lbls = next(pipe)
                    m = step(model, imgs, lbls)
                    batches.append((imgs, lbls))
                    losses.append(m["loss"])
                torch.cuda.synchronize()
            finally:
                pipe.close()
            dt = time.perf_counter() - t0
            counts.append((before, _spill_counts(ctx) if cached else {},
                           bpe * B / dt))
    finally:
        ctx.close()
    del model, step
    return batches, losses, counts


def phase_spill(workdir: str, pdec: str) -> None:
    """Phase 7e: the NVMe spill tier under the hot cache. arm=pread: the
    reference's epoch pair at 1 GiB, spill_compress off then on. arm=resnet:
    BASELINE config #2's predecoded shard into ResNet-50 for 3 epochs with
    hot_cache_bytes 64 MiB, admission "always" and a 1 GiB spill file,
    against the same run with no cache: batches and losses bit-equal, and
    no source misses from epoch 2 on."""
    toks = np.random.default_rng(7).integers(0, 1 << 15, GiB // 4,
                                             dtype=np.int32)
    for compress in (False, True):
        _spill_pread_arm(workdir, toks, compress)
    del toks
    B, epochs = 128, 3
    base = StromConfig.from_env()
    cached_cfg = dataclasses.replace(
        base, hot_cache_bytes=64 * MiB, hot_cache_admit="always",
        spill_bytes=GiB, spill_dir=os.path.join(workdir, "spill"))
    want_b, want_l, plain = _spill_resnet_run(pdec, base, epochs, B, False)
    say("spill", arm="resnet", batch=B, epochs=epochs,
        hot_cache_bytes=cached_cfg.hot_cache_bytes,
        admit=cached_cfg.hot_cache_admit, spill_bytes=cached_cfg.spill_bytes,
        prefetch_depth=1,
        uncached_last_losses=",".join(f"{float(x):.6f}"
                                      for x in want_l[-3:]))
    got_b, got_l, counts = _spill_resnet_run(pdec, cached_cfg, epochs, B,
                                             True)
    _same_batches("spill resnet", got_b, want_b)
    same = [torch.equal(a, b) for a, b in zip(got_l, want_l)]
    misses = []
    for e, (before, after, rate) in enumerate(counts):
        misses.append(_spill_epoch_line(
            "resnet", e, before, after, images_per_s=f"{rate:.1f}",
            uncached_images_per_s=f"{plain[e][2]:.1f}", batches_exact=True,
            losses_equal=all(same[e * len(same) // epochs:
                                  (e + 1) * len(same) // epochs])))
    if not all(same) or len(got_l) != len(want_l):
        raise AssertionError(f"spill resnet: losses differ from the uncached "
                             f"run's at steps {[i for i, s in enumerate(same) if not s]}")
    if any(m != 0 for m in misses[1:]) or counts[-1][1]["spill_hit_bytes"] \
            <= 0 or counts[-1][1]["spill_errors"]:
        raise AssertionError(f"spill resnet: source misses by epoch "
                             f"{misses}, counters {counts[-1][1]}")
    say("spill", arm="resnet", check="batches and losses equal the uncached "
        "run's; no source misses from epoch 2 on", exact=True,
        last_loss=f"{float(got_l[-1]):.5f}")
    del got_b, want_b
    torch.cuda.empty_cache()


# ----------------------------------------------------- multitenant (10)
MT_LLAMA_STEPS = 16
MT_VIS_BATCHES = 48
MT_PQ_SCANS = 12


def _mt_delta(scope, snap0: dict) -> dict:
    """A tenant's SCHED_FIELDS counters since *snap0* (a snapshot of its
    scope), with the queue-wait and per-op latency percentiles of the
    bucket deltas."""
    snap1 = scope.snapshot()
    out = {k: int(snap1.get(k, 0) - snap0.get(k, 0))
           for k in ("sched_granted_ops", "sched_granted_bytes",
                     "sched_throttle_waits")}

    def buckets(stem: str) -> list:
        b0 = snap0.get(stem + "_hist") or [0] * 24
        return [a - b for a, b in zip(snap1.get(stem + "_hist") or [0] * 24,
                                      b0)]

    qw = buckets("sched_queue_wait")
    out["sched_queue_wait_p50_us"] = percentile_from_buckets(qw, 0.50)
    out["sched_queue_wait_p99_us"] = percentile_from_buckets(qw, 0.99)
    out["engine_op_lat_p99_us"] = percentile_from_buckets(
        buckets("engine_op_lat"), 0.99)
    return out


def phase_multitenant(workdir: str, pdec: str, pq_paths: list[str],
                      pq_hits: int) -> None:
    """Phase 10: the reference's bench_multitenant at full width on one
    context with three registered tenants: llama (training; phase 4's
    shards into the captured flash step, Llama-3-8B widths, 2 layers, batch
    2 x 2048, from a fresh state of one seed, 16 timed steps), vis0
    (training; the predecoded ResNet-50 loader alone, batch 128 x 224^2)
    and pq (interactive; phase 9's narrow scan, repeated). Each solo, then
    the three concurrently on threads, then concurrently with
    sched_enabled=False. Concurrent Llama losses equal the solo run's bit
    for bit, every pq count is exact, and the llama tenant launches the
    three sm90 kernels."""
    cuda = torch.device("cuda")
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    tok_paths = [os.path.join(workdir, f"tokens{i}.bin") for i in range(2)]
    for p in tok_paths + [pdec] + pq_paths:
        if not os.path.exists(p):
            raise AssertionError(f"multitenant: fixture {p} is gone")

    def llama(ctx, ready=None, go=None) -> dict:
        pipe = make_llama_pipeline(
            ctx, tok_paths, batch=2, seq_len=2047, device="cuda", seed=0,
            scope={"pipeline": "llama", "tenant": "llama"})
        state = init_train_state(cfg, device="cuda", seed=0)
        step = make_train_step(cfg, attn="flash", device="cuda")
        losses = []
        try:
            # the warm-up and the capture before the others start
            for _ in range(2):
                state, m = step(state, next(pipe))
                losses.append(m["loss"])
            torch.cuda.current_stream().synchronize()
            if ready is not None:
                ready.set()
                go.wait()
            stalls0 = pipe.data_stall_steps
            t0 = time.perf_counter()
            for _ in range(MT_LLAMA_STEPS):
                state, m = step(state, next(pipe))
                losses.append(m["loss"])
            torch.cuda.current_stream().synchronize()
            dt = time.perf_counter() - t0
            if step.last_call != "replay":
                raise AssertionError("multitenant llama: the timed steps "
                                     "did not replay the captured graph")
            return {"items_per_s": MT_LLAMA_STEPS * 2 * 2048 / dt,
                    "step_ms": dt / MT_LLAMA_STEPS * 1e3,
                    "stalls": pipe.data_stall_steps - stalls0,
                    "losses": torch.stack(losses).cpu()}
        finally:
            pipe.close()
            del state, step

    def vis(ctx, ready=None, go=None) -> dict:
        pipe = make_predecoded_vision_pipeline(
            ctx, [pdec], batch=128, image_size=IMAGE, device=cuda,
            scope={"pipeline": "resnet", "tenant": "vis0"})
        try:
            next(pipe)
            if ready is not None:
                ready.set()
                go.wait()
            t0 = time.perf_counter()
            for _ in range(MT_VIS_BATCHES):
                imgs, _lbls = next(pipe)
            torch.cuda.current_stream().synchronize()
            dt = time.perf_counter() - t0
            return {"items_per_s": MT_VIS_BATCHES * 128 / dt}
        finally:
            pipe.close()

    def pq(ctx, ready=None, go=None) -> dict:
        if ready is not None:
            ready.set()
            go.wait()
        t0 = time.perf_counter()
        counts = [parquet_count_where(
            ctx, pq_paths, "value", lambda v: v > 0,
            scope={"pipeline": "parquet", "tenant": "pq"})
            for _ in range(MT_PQ_SCANS)]
        dt = time.perf_counter() - t0
        if any(c != pq_hits for c in counts):
            raise AssertionError(f"multitenant pq: counts {counts} against "
                                 f"{pq_hits}")
        return {"items_per_s": MT_PQ_SCANS * PQ_SHARDS * PQ_ROWS / dt}

    workloads = {"llama": llama, "vis0": vis, "pq": pq}

    def make_ctx(sched: bool) -> StromContext:
        ctx = StromContext(StromConfig.from_env(sched_enabled=sched),
                           scope={"phase": f"multitenant-{sched}"})
        if sched:
            ctx.register_tenant("llama", priority="training")
            ctx.register_tenant("vis0", priority="training")
            ctx.register_tenant("pq", priority="interactive")
        return ctx

    def concurrent(ctx) -> tuple[dict, float]:
        out: dict = {}
        errs: list = []
        go = threading.Event()
        readies = {n: threading.Event() for n in workloads}

        def run(name):
            try:
                out[name] = workloads[name](ctx, readies[name], go)
            except BaseException as e:   # surfaced after the join
                errs.append((name, e))
                readies[name].set()

        ths = [threading.Thread(target=run, args=(n,), name=f"mt-{n}")
               for n in workloads]
        for t in ths:
            t.start()
        for ev in readies.values():
            ev.wait()
        t0 = time.perf_counter()
        go.set()
        for t in ths:
            t.join()
        if errs:
            raise errs[0][1]
        return out, time.perf_counter() - t0

    ctx = make_ctx(True)
    sched = ctx.scheduler
    rate = ENGINE_ALONE_GBPS[-1] if ENGINE_ALONE_GBPS else 2.0
    slice_s = sched._slice_bytes() / (rate * 1e9)
    say("multitenant", tenants="llama:training,vis0:training,pq:interactive",
        exclusive=sched.exclusive, slice_bytes=sched._slice_bytes(),
        engine=ctx.engine.stats()["engine"], llama_steps=MT_LLAMA_STEPS,
        vis_batches=MT_VIS_BATCHES, pq_scans=MT_PQ_SCANS)
    try:
        solo, solo_sched = {}, {}
        for name, fn in workloads.items():
            t = sched.tenant(name)
            snap0 = t.scope.snapshot()
            solo[name] = fn(ctx)
            solo_sched[name] = _mt_delta(t.scope, snap0)
            say("multitenant", arm="solo", tenant=name,
                items_per_s=f"{solo[name]['items_per_s']:.1f}",
                **{k: v for k, v in solo[name].items()
                   if k not in ("items_per_s", "losses")},
                **solo_sched[name])
        snaps = {n: sched.tenant(n).scope.snapshot() for n in workloads}
        fa.reset_launch_counts()
        conc, wall = concurrent(ctx)
        launches = check_variants(KERNELS, dict(fa.VARIANT_LAUNCHES),
                                  "multitenant llama tenant")
        ratios = []
        for name in workloads:
            d = _mt_delta(sched.tenant(name).scope, snaps[name])
            vs = conc[name]["items_per_s"] / solo[name]["items_per_s"]
            ratios.append(vs)
            say("multitenant", arm="concurrent", tenant=name,
                items_per_s=f"{conc[name]['items_per_s']:.1f}",
                vs_solo=f"{vs:.3f}",
                **{k: v for k, v in conc[name].items()
                   if k not in ("items_per_s", "losses")}, **d)
        pq_wait = _mt_delta(sched.tenant("pq").scope, snaps["pq"])
        say("multitenant", arm="concurrent", wall_s=f"{wall:.3f}",
            mt_vs_solo_mean=f"{statistics.mean(ratios):.3f}",
            llama_data_stalls_timed=conc["llama"]["stalls"],
            pq_queue_wait_p99_us=pq_wait["sched_queue_wait_p99_us"],
            one_slice_us=f"{slice_s * 1e6:.0f}",
            one_slice_at_gbps=f"{rate:.3f}",
            launches=json.dumps(launches, sort_keys=True),
            sched=json.dumps(sched.stats(), sort_keys=True))
        if not torch.equal(conc["llama"]["losses"], solo["llama"]["losses"]):
            raise AssertionError(
                f"multitenant: concurrent llama losses "
                f"{conc['llama']['losses'].tolist()} differ from solo "
                f"{solo['llama']['losses'].tolist()}")
        say("multitenant", check="concurrent llama losses equal solo, pq "
            "counts exact", exact=True,
            last_losses=",".join(f"{x:.6f}" for x in
                                 conc["llama"]["losses"].tolist()[-4:]))
    finally:
        ctx.close()
    torch.cuda.empty_cache()
    off = make_ctx(False)
    try:
        conc_off, wall_off = concurrent(off)
    finally:
        off.close()
    say("multitenant", arm="concurrent_sched_off", wall_s=f"{wall_off:.3f}",
        **{f"{n}_items_per_s": f"{conc_off[n]['items_per_s']:.1f}"
           for n in workloads},
        **{f"{n}_vs_solo":
           f"{conc_off[n]['items_per_s'] / solo[n]['items_per_s']:.3f}"
           for n in workloads},
        llama_data_stalls_timed=conc_off["llama"]["stalls"])
    if not torch.equal(conc_off["llama"]["losses"], solo["llama"]["losses"]):
        raise AssertionError("multitenant: llama losses with the scheduler "
                             "off differ from the solo run's")
    torch.cuda.empty_cache()


PROFILE_PAD_S = 0.1   # on the card, ~15 us of drift a second of process age


def profile_step(step, state, batch) -> None:
    """One more step, after the timed ones, under torch.profiler: one
    replay of the step's graph. Device time by kernel group and the
    device's busy share of the step's wall time (the union of device
    intervals over the host clock). Where the profiler saw no kernel but
    the input copy (none of the graph's), it says so and reports nothing
    as a measurement."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler keeps only device events that its clock conversion,
        # which drifts as the process ages, puts inside the session: a
        # pause on either side keeps the step's events inside it
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        metrics = step(state, batch)[1]
        torch.cuda.synchronize()   # the wait: no ATen op's self time
        wall_us = (time.perf_counter() - t0) * 1e6
        metrics["loss"].item()
        time.sleep(PROFILE_PAD_S)
    # device kernels and copies only: a range annotation (the optimizer's
    # step, say) is mirrored on the device timeline over its kernels
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    kernels = [sp for sp in spans if _kernel_group(sp[2]) != "memcpy/memset"]
    if not kernels:
        say("profile", device_time="not measured", device_events=len(spans),
            note="the profiler recorded no kernel of the step's graph")
        return
    # host time inside ATen ops (self time, so nested ops count once; not
    # the CUDA runtime's calls, whose synchronize is the wait for the
    # device); the rest of the host clock is Python and the autograd engine
    host_ops_us = sum(e.self_cpu_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and e.key.startswith("aten::"))
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
    # cuBLAS's kernels for operands not 16-byte aligned (ViT's S 197 rows)
    align1 = [(n, us) for name, (n, us) in by_name.items() if "align1" in name]
    say("profile", device_kernels=len(kernels), step_ms=f"{wall_us / 1e3:.1f}",
        device_busy_ms=f"{busy / 1e3:.1f}",
        device_idle_share=f"{1 - busy / wall_us:.3f}",
        host_aten_self_ms=f"{host_ops_us / 1e3:.1f}",
        align1_calls=sum(n for n, _ in align1),
        align1_ms=f"{sum(us for _, us in align1) / 1e3:.2f}",
        **{f"{g}_ms": f"{us / 1e3:.2f}" for g, us in
           sorted(groups.items(), key=lambda kv: -kv[1])})
    for name, (n, us) in by_name.items():
        if "align1" in name:
            say("profile", align1_kernel=name[:110].replace(" ", "_"), calls=n,
                ms=f"{us / 1e3:.3f}")
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
        wide_launches = phase_wide_path()
        path = phase_ssd2gpu(workdir)
        launches = phase_train(workdir)
        phase_ckpt(workdir)
        phase_stream(path)
        os.unlink(path)
        model, step, pdec = phase_resnet(workdir)
        tar = phase_resnet_jpeg(workdir, model, step)
        if tar is None:
            say("auto_depth", skipped=NO_JPEG)
        else:
            phase_auto_depth(tar, model, step)
        phase_cache(pdec)
        phase_decoded_cache(tar, model, step)
        del model, step
        torch.cuda.empty_cache()
        phase_spill(workdir, pdec)
        phase_vit(pdec, tar)
        pq_paths, pq_hits = phase_parquet(workdir, tar)
        phase_multitenant(workdir, pdec, pq_paths, pq_hits)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kernels = [{"name": name, "route": "cuda", "source": info["source"],
                "design": info["design"], "replaces": info["replaces"],
                "launches": launches[name],
                **{k: rows[name]["main"][k] for k in
                   ("max_abs_err", "ms", "ms_min", "ms_max", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")},
                **({"library_covers": "fa_bwd_dkv + fa_bwd_dq (SDPA backward)"}
                   if name != "fa_fwd" else {})}
               for name, info in KERNELS.items()]
    kernels += [{"name": name, "route": "cuda", "source": info["source"],
                 "design": info["design"], "replaces": info["replaces"],
                 "launches": wide_launches[name],
                 "shape": "gemma2_9b " + json.dumps(GEMMA2_9B),
                 **{k: rows[info["counter"]]["gemma2_9b"][k] for k in
                    ("max_abs_err", "ms", "ms_min", "ms_max", "plain_ms",
                     "bound_ms", "bound_by", "library_ms")},
                 **({"library_covers": "fa_bwd_dkv + fa_bwd_dq (SDPA backward)"}
                    if info["counter"] != "fa_fwd" else {})}
                for name, info in WIDE_KERNELS.items()]
    kernels += [{"name": name, "route": "cuda", "source": info["source"],
                 "design": info["design"], "replaces": info["replaces"],
                 "launches": launches[name],
                 "shape": f"{label} {json.dumps(shape)}",
                 **{k: rows[info["counter"]][label][k] for k in
                    ("max_abs_err", "ms", "ms_min", "ms_max", "plain_ms",
                     "bound_ms", "bound_by", "library_ms")},
                 "library_covers": (f"SDPA {kind} forward, TF32 off"
                                    if info["counter"] == "fa_fwd" else
                                    f"fa_bwd_dkv + fa_bwd_dq (SDPA {kind} "
                                    "backward, TF32 off)")}
                for table, label, shape, kind in (
                    (F32_KERNELS, "main_f32", [2, 2048, 32, 8, 128], "f32"),
                    (DH512_KERNELS, "gemma2_9b_dh512", GEMMA2_9B_DH512,
                     "bf16"))
                for name, info in table.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
