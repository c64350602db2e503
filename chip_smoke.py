"""Run the PyTorch port's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases build,kernels,dp,dp_vision  # alone
    python3 chip_smoke.py --phases build,kernels,tp_sp         # alone
    python3 chip_smoke.py --phases build,kernels,ep            # alone

Phases, in order; any failure ends the run with a non-zero exit.
``--phases`` runs a subset of the phases that take nothing from another
(build, kernels, wide_path, train, ckpt, dp, dp_vision, tp_sp, ep, dist), for
a machine with four cards where only the many-card paths need them:

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
               [sched]: 6 rounds of the 1 GiB streamed delivery through a
               context with the multi-tenant scheduler (the default) and
               one with sched_enabled=False, beside the engine alone, in
               alternating order: each arm's GB/s, both deliveries' ratio
               to the engine alone, exact bytes, and the scheduler's
               stats(), whose granted bytes must equal the bytes delivered
               through it; whether the circuit breaker was on (it is by
               default); the median ratio with the scheduler must reach
               0.90 (SCHED_LIMIT). Last, the file striped RAID0 over 4 member
               files, checked with check_file, and delivered through a
               striped alias under 4 rings and under 1, exact.
3b. numa    -- [numa]: the host's NUMA nodes (/sys/devices/system/node)
               and CPUs per node, the node of the disk under phase 3's
               file and of the card (/sys/bus/pci/devices/<bus id>/
               numa_node). On more than one node, phase 3's 1 GiB delivery
               with numa_affinity off and on (slabs bound to the disk's
               node, else the card's, before cudaHostRegister pins them),
               alternating for 4 rounds: GB/s and host CPU s per GiB; on
               one node, uma=True and no A/B. irq_affinity stays off (it
               writes /proc/irq, a setting of the machine).
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
               StepToken (pipe.token(ctx)): bytes, leaves, MB/s with
               the commit, the device-to-host share; 3 more steps of the
               uninterrupted run; restore_checkpoint onto a fresh state on
               the card (load_train_state) and a fresh pipeline from the
               token (a fresh pipeline moved there by restore(token)),
               every leaf equal to the saved one (ckpt_roundtrip_ok)
               and restore MB/s; 3 resumed steps on a new captured step,
               whose losses, grad norms and final leaves must equal the
               uninterrupted run's bit for bit (resume_ok), the flash
               kernels' launches counted over them as in phase 4
               (the pickle baseline runs in phase 13, at Llama small);
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
               reference's spill epoch pair at 128 MiB (a seeded int32 token
               shard, values below 2^15, written through
               write_token_shard(ctx, ...); hot_cache_bytes 16 MiB,
               admission "always", spill_bytes 256 MiB in the work
               directory; 32 records of 4 KiB a pread; two epochs), with
               spill_compress off and then on (the reference's 1 GiB cut
               to 128 MiB to keep the run inside its time): per epoch the
               SPILL_FIELDS, cache_miss_bytes, engine bytes, MB/s, the
               compression ratio and the codec's name; every read equal to the shard's bytes
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
10. multitenant -- strom_torch.cli.bench_multitenant (the reference's
               arm) at full width on one
               context with three registered tenants: llama (training:
               phase 4's shards into a fresh captured flash step, 2 warm-up
               and capture steps, then 16 timed), vis0 (training: phase
               6's shard through the predecoded loader alone, 48 batches
               of 128) and pq (interactive: phase 9's narrow scan, 12
               times). Each solo, then the three started at once on
               threads, then the same with the scheduler off
               (STROM_SCHED_ENABLED=0). Per
               tenant the SCHED_FIELDS (items/s, vs_solo, queue-wait p50
               and p99, granted ops and bytes, throttle waits, the engine's
               per-op p99), mt_vs_solo_mean, Llama's timed data stalls, and
               pq's p99 queue wait beside one slice's time at 2 GB/s. The
               concurrent Llama losses must equal solo's bit for bit (both
               modes), every pq count is exact, and the Llama tenant must
               launch the three sm90 kernels.
11. resilience -- [chaos]: strom_torch.cli.bench_chaos. Phase 7's JPEG
               tar through make_imagenet_resnet_pipeline (skipped= where
               phase 7 was) and phase 6's predecoded shard through
               make_predecoded_vision_pipeline, batch 128 into device
               memory, 4 batches, residency_hybrid off and io_retries 3:
               once clean, once under fault_plan="chaos:0"; every batch
               hashed after .cpu(); the CHAOS_BENCH_FIELDS, chaos_ok must
               be 1 and chaos_faults_injected above 0 (chaos_hedges_fired
               is 0: hedged reads are not ported). [breaker]: a seeded 256
               MiB file through memcpy_ssd2gpu with the engine dead from
               op 16 (breaker_min_events 1): exact, at least one trip,
               failover_bytes covering the rest; then 64 MiB while the
               breaker is open: exact, no op on the primary. [deadline]:
               a 0.5 s latency on every read, pread(deadline_s=0.05) must
               raise DeadlineExceeded within 0.05 s plus the 1 s drain
               grace; a tenant queued behind a held grant with a 0.2 s
               deadline leaves the queue at it. [handle]: 64 and 256 MiB
               async deliveries, block_until_ready(), the tensor read on a
               fresh stream with no synchronize: exact; elapsed_s.
               [resume]: strom_torch.cli.bench_resume with --model tiny,
               one async save (its round trip exact), then
               run_kill_resume(seed=1) (three trainer processes: the
               reference run, one SIGKILLed mid-epoch, the restart):
               RESUME_FIELDS; resume_ok, which holds the restart serial,
               the batch stream and no tmp checkpoint left, must be 1.
12. observability -- one context with an ephemeral metrics_port, the
               snapshot history and a flight directory. [server]: phase
               4's Llama step (Llama-3-8B widths, 2 layers, flash,
               captured) for 16 steps from a fresh state and pipeline, in
               four arms, the scraper off, on, on, off; with it on, a
               thread GETs every route once (each one's status, bytes and
               ms; 200 except the documented 404 of /tune and /cluster and
               400 of a malformed since_us) and then
               /metrics?sections=context,sched at 20 Hz beside the
               capture and the replays (scrapes, ms, the /metrics lines
               and bytes); each arm's median replay ms; the losses and
               grad norms of all four arms must be equal. Then phase 7's
               JPEG loader alone, 4 batches from a dropped page cache,
               with the server, the history and the 20 Hz scraper and
               without (off, on, on, off): images/s each. [slo]: two
               tenants, one with a gather target under half its own
               engine ops' p50: it must burn on /slo and on its /tenants
               row, the other must not. [federation]: a ClusterView over this context's
               endpoint and a subprocess context's (python -c, a registry
               of its own): the aggregate's counters must equal the hosts'
               sum; killing the subprocess must flip it unhealthy within
               stale_s plus two poll intervals and leave a flight bundle.
               [history]: the ring's samples and a rate. [tune]:
               strom_torch.cli.bench_tune at the reference's defaults (128
               MiB in 128 KiB blocks, shuffled, a 32 MiB cache, 16 trials,
               3 iterations, then an interleaved A/B): hand, tuned and
               searched items/s, moves, reverts, holds; tuned_vs_hand must
               be at least 1.0. Then attach_tuner(
               start=False) on the JPEG ResNet loader feeding a captured
               ResNet-50 step: 4 beats of 2.05 s, each beat's goodput,
               action and knobs (skipped= where phase 7 was). [inflight]:
               the engine_inflight gauge read from another thread during a
               256 MiB gather on the preadv pool (above 0) and after it
               (0).
12b. dp     -- the data-parallel path over every card of the machine:
               world 1, and where there are N > 1 cards then world N, one
               process a card (this script with --dp-worker; the parent
               has built the kernels), joined by torch.distributed (NCCL,
               and gloo for host collectives). Rank 0 prints [topo]
               (nvidia-smi topo -m, the NCCL version). Each rank holds the
               three kernels against their plain versions on its own card
               at the main shape (BF16_TOL); reads Llama-3-8B widths with
               2 of 32 layers, 2 rows a card x 2048 tokens, from two
               seeded token shards (3 global batches an epoch) through
               make_llama_pipeline(sharding=P("dp", None), epoch_sync=True)
               into make_train_step(mesh=), captured with its NCCL
               all-reduces: 4 counted steps (every kernel launched on
               every rank), 4 timed, across two epoch boundaries. Each
               step's local rows and the all-gathered global batch must
               equal the file's rows in sampler order, bit for bit, and
               the replicas' parameter checksums (each parameter's bits
               summed) must be equal after every step; rank 0's loss and
               grad_norm of the counted steps must agree, within
               DP_PLAIN_RTOL, with make_train_step without a mesh on the
               whole global batch from the same parameters (run first,
               on rank 0's card alone); the engine must
               have read only the rank's rows (bytes_read = deliveries x
               one rank's rows); 0 data stalls in the timed steps. Then
               the straggler report, one replay under torch.profiler (the
               NCCL kernels' device ms and share of the step), and phase
               9's wide scan (warm) with reduce="collective" and
               "allgather": hits exact against numpy, the feature sum in
               phase 9's bound, on every rank. Per world: each rank's
               median step ms, the losses equal on every rank, tokens/s;
               then the weak-scaling ratio (world N's median step over
               world 1's), beside each card's name and power limit. Last,
               the launched CLI on every card: python -m
               torch.distributed.run --nproc-per-node N -m strom_torch.cli
               llama --train-step --model small --attn flash, 8 rows a
               card (one JSON line, devices N, a finite loss, the three
               sm90 kernels launched on every rank).
12c. dp_vision -- the vision pipelines and the ResNet-50 and ViT-B/16
               steps over every card, world 1 and then world N, one
               worker process a card (this script with
               --dp-vision-worker), from phase 6's predecoded shard and
               phase 7's tar (made here, seeded as those phases make
               them, when they did not run). ResNet-50, full width, bf16,
               128 rows a card through make_predecoded_vision_pipeline(
               sharding=P("dp", None, None, None)) into
               make_resnet_sgd_step(mesh=), captured with its NCCL
               all-reduces (the gradient buckets and the loss, and each
               batch norm's statistics over the global batch, forward and
               backward): 4 counted steps, 4 timed. Each step's local
               images and labels must equal the file's rows in sampler
               order, bit for bit; the parameters' and the batch-norm
               statistics' checksums equal on every rank after every
               step; rank 0's counted losses and grad norms within
               DPV_PLAIN_RTOL of make_resnet_sgd_step without a mesh on
               the whole global batch from the same parameters (run
               first, on rank 0's card alone), beside one step with
               rank-local statistics (its gap printed, with whether it
               would fail that check); the engine must have read only the
               rank's rows, with 0 timed data stalls; one replay under
               torch.profiler splits the NCCL device ms into the batch
               norms' and the gradient buckets'. Then the JPEG-fed arm
               (make_imagenet_resnet_pipeline(sharding=), streamed, 4
               steps): each built batch decoded exactly the rank's 128
               rows (the decode routes and decode_slot_bytes), and the
               first batch's rows equal one process's decode of the whole
               global batch. Then ViT-B/16 at 64 rows a card: 4 counted,
               4 timed, replicas equal. Per world each rank's median step
               ms, images/s and all-reduce ms; then each model's weak
               scaling; on N cards last, the launched CLI: python -m
               torch.distributed.run --nproc-per-node N -m strom_torch.cli
               resnet --train-step --predecoded, 128 rows a card (devices
               N, a finite loss).
12d. tp_sp  -- tensor and sequence parallelism, one worker process a card
               (this script with --tp-sp-worker; the parent has built the
               kernels), phase 4's model (Llama-3-8B widths, 2 of 32
               layers, bf16), fed from a seeded token file an arm by
               make_llama_pipeline(sharding=batch_sharding(mesh, sp=)),
               P("dp", "sp") on the mesh's axes. World 1: one arm, {"dp":
               1, "tp": 1, "sp": 1} at 1 x 2048, the flash ring of one. On
               four cards or more, world 4: first each rank's flash and
               zigzag rings over sp 4 at its block of 1 x 2048 x 32 heads
               (Dh 128, bf16) against the dense ring in f32
               (BF16_VS_F32_TOL: out, dq, dk, dv); then the arms tp4
               ({"tp": 4}, 2 x 2048, 8 q and 2 kv heads a rank, flash),
               sp4_flash and sp4_zigzag ({"sp": 4}, 1 x 8192, S_l 2048)
               and tp2sp2 ({"tp": 2, "sp": 2}, 2 x 4096, 16/4 heads, S_l
               2048, flash). Each arm: 4 counted steps of make_train_step(
               mesh=, sp=, attn=) (the warm-up, the capture, 2 replays)
               and 4 timed, each step's local block equal to the file's
               rows in sampler order; rank 0's counted losses and grad
               norms within TPSP_PLAIN_RTOL of make_train_step without a
               mesh on the global batch from the same parameters (run
               first on rank 0's card, then timed over as many replays);
               after every step the blocks of ranks that share a tp
               coordinate, and the tp-replicated norms of every rank,
               bit-equal (parameter checksums); each rank's launches of
               the counted steps by row of KERNELS (check_variants) and
               equal to the count the ring's blocks give
               (_tp_sp_launches); the engine read only the rank's block
               (bytes_read = deliveries x rows x L/sp x 4). Then one
               replay under torch.profiler: the NCCL AllReduce, SendRecv
               and AllGather device ms and their shares of the step.
               Printed a rank: the median step ms, tokens/s, the plain
               step's ms over the arm's (plain_over_arm), each card's name
               and power limit; a line an arm with every rank's medians,
               shares and whether the losses are equal on every rank (they
               must be).
12e. ep     -- the MoE model with expert parallelism, one worker process
               a card (this script with --ep-worker): EP_CONFIG, phase 4's
               attention (Llama-3-8B widths, 2 of 32 layers, bf16, flash)
               with 8 SwiGLU experts a layer of Mixtral-8x7B's shape,
               top-1, capacity factor 1.25 (3.95 B parameters), fed from
               a seeded token file an arm by make_llama_pipeline(sharding=
               batch_sharding(mesh, sp=)). World 1: make_moe_train_step
               without a mesh at 2 x 2048, then on {"ep": 1}: each step's
               loss and grad norm, the final parameters and the routes
               equal bit for bit. On four cards or more, world 4: dp2ep2
               ({"dp": 2, "ep": 2}, 4 x 2048, 4 experts a rank) and
               ep2sp2 ({"ep": 2, "sp": 2}, 2 x 4096, the flash ring, S_l
               2048). Each arm: 4 counted steps (the warm-up, the
               capture, 2 replays) and 4 timed, each step's local block
               equal to the file's rows in sampler order; at world 4 rank
               0's counted losses and grad norms within EP_PLAIN_RTOL of
               the step without a mesh on the global batch from the same
               parameters (run first on rank 0's card, its routes of the
               first batch broadcast), and each rank's count of tokens
               whose expert (and kept flag) differs from that step's at
               the same places; after every step the blocks of the ranks
               that share an ep coordinate, and the replicated parameters
               of every rank, bit-equal (checksums); each rank's launches
               of the counted steps by row of KERNELS, equal to the
               count the ring's blocks give; the engine read only the
               rank's block. One replay under torch.profiler: the NCCL
               AllReduce, AllGather and SendRecv shares (before it, world
               1's meshless arm prints phase 4's [profile] lines: device
               ms by kernel group and the top kernels). Printed: the
               steady step ms (median, min, max), tokens/s, the
               dropped-token share and the largest expert's load over C
               (the global batch's routes), the peak memory, the launches
               a step; a line an arm with every rank's medians and
               shares, and whether the losses are equal on every rank
               (they must be).
13. cli     -- strom_torch.cli as a user runs it: subprocesses of python
               -m strom_torch.cli ... --json --tmpdir <work dir>: nvme (256
               MiB; --numa-node the disk's node where it has one), check of
               its file, all (the reference's twelve phases at their quick
               shapes, ssd2gpu for ssd2tpu: rc 0, failed [], every byte
               count the size asked for, the four Parquet counts equal to
               numpy's over the same seeded column, finite losses,
               Llama-small's data-stall steps, and its flash step's
               launches, which must be the three sm90 kernels),
               checkpoint --model small (round trip exact, no spill-epoch
               source miss) and daemon (the ready line, a tenant
               registered over POST /tenants, SIGTERM: drained with
               stuck=[] and ended by the signal). A line a subcommand with
               its seconds and the fields it checked.
14. dist    -- the peer fabric (strom_torch/dist), lines [dist] arm=...:
               host-mode fleets of worker processes over 4 seeded token
               shards of 1,024 rows x 2,048 int32 tokens, 32 rows a global
               batch, 16 steps, each worker its own context (the default
               engine, a 256 MiB hot cache) and peer server: 1, 2 and 4
               processes, then at 4 the batched wire against
               batch_extents=0 and against peer_compress, and rank 1 of 3
               killed after step 2. Every judged worker's rows must hash to
               reference_shard_hashes (dist_ok 1), deliver its own rows
               only, and, without a kill, read nothing from its engine
               during ingest (dist_engine_ingest_bytes 0); the killed
               fleet leaves dead_1. Printed: items/s, dist_vs_single, the
               peer hit ratio, round trips, each rank's assembly wait p50
               and p99, dist_batch_vs_single and dist_peer_comp_vs_raw.
               Then decoded frames cluster-wide: host A (another process)
               holds one epoch of phase 7's tar decoded; host B's JPEG
               ResNet-50 pipeline on card 0, alone and then peered with A:
               the same batches bit for bit, and with peers B decodes only
               the frames A did not hold; B's step ms both ways. Then
               python -m strom_torch.cli dist --procs 2 (rc 0, dist_ok 1).
               With 4 cards or more: measure_ingest(4, mode="mesh"), one
               worker a card, memcpy_ssd2gpu(sharding=) of each batch, and
               the CLI's dist --mode mesh --procs 4; else a skip line.

Each phase prints its own lines, and a [phase] line with its seconds. The line before the last is one JSON
object describing every kernel; the last line is the result,
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with an error and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import functools
import glob
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

from typing import Callable

import numpy as np
import torch

import strom_torch
from strom_torch import cli
from strom_torch.config import StromConfig
from strom_torch._core import build as core_build
from strom_torch.ckpt import (AsyncCheckpointer, load_manifest,
                              restore_checkpoint, save_checkpoint)
from strom_torch.ckpt.checkpoint import (_host_leaves, tree_flatten,
                                         tree_unflatten)
from strom_torch.ckpt.jobstate import RESUME_FIELDS, TOKEN_KEY, StepToken
from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.core import StripedFile, StromContext
from strom_torch.delivery.extents import Extent, ExtentList
from strom_torch.delivery.shard import Segment
from strom_torch.engine import make_engine
from strom_torch.engine.base import DeadlineExceeded, EngineError
from strom_torch.engine.resilience import (CHAOS_BENCH_FIELDS,
                                           RESILIENCE_FIELDS)
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
from strom_torch.dist.launch import make_fixture, measure_ingest
from strom_torch.formats.rawbin import TokenShardSet, write_token_shard
from strom_torch.models.llama import LlamaConfig, next_token_loss
from strom_torch.models.moe import MoEConfig
from strom_torch.models.resnet import ResNet, ResNetConfig
from strom_torch.models.vit import ViT, ViTConfig
from strom_torch.ops import build
from strom_torch.ops import flash_attention as fa
from strom_torch.ops.pushdown import PUSHDOWN_FIELDS, OpGraph, col
from strom_torch.parallel.train import (init_moe_train_state,
                                        init_train_state, load_train_state,
                                        make_moe_train_step,
                                        make_resnet_sgd_step, make_train_step,
                                        make_vit_sgd_step, train_state_tree)
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline
from strom_torch.pipelines.parquet_scan import (parquet_count_where,
                                                parquet_scan_aggregate)
from strom_torch.pipelines.sampler import EpochShuffleSampler, SamplerState
from strom_torch.utils.codec import default_codec
from strom_torch.faults import FaultPlan, FaultyEngine
from strom_torch.obs import chrome_trace, stall
from strom_torch.obs.events import ring as events_ring
from strom_torch.obs.flight import load_bundle
from strom_torch.utils import locks
from strom_torch.utils.stats import global_stats, percentile_from_buckets
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


SCHED_ROUNDS = 6
# delivered with the scheduler (and the breaker) on, over the engine alone,
# median of SCHED_ROUNDS: below it the phase fails. A single round read
# 0.848-1.227 on an H100 80GB HBM3 at 700 W, so the check is on the median
SCHED_LIMIT = 0.90
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
    on_vs = statistics.median(res["sched_on"]) / statistics.median(
        res["engine"])
    say("sched", **{k: v for k, v in st.items()},
        breaker_on=ctxs["sched_on"].resilience.breaker is not None,
        breaker_state=ctxs["sched_on"].stats()["resilience"]["state"],
        limit=SCHED_LIMIT, sched_on_limit_met=on_vs >= SCHED_LIMIT,
        slice_bytes=sched._slice_bytes(),
        default_tenant_granted_ops=tenant.granted_ops,
        default_tenant_granted_bytes=tenant.granted_bytes,
        **{f"{a}_gbps_median": f"{statistics.median(res[a]):.4f}"
           for a in arms},
        **{f"{a}_vs_engine_median":
           f"{statistics.median(res[a]) / statistics.median(res['engine']):.4f}"
           for a in arms[1:]})
    ENGINE_ALONE_GBPS.append(statistics.median(res["engine"]))
    for c in ctxs.values():
        c.close()
    if st["sched_granted_bytes"] != (SCHED_ROUNDS + 1) * GiB \
            or st["sched_active_grants"] != 0:
        raise AssertionError(f"sched: granted {st['sched_granted_bytes']} "
                             f"bytes for {SCHED_ROUNDS + 1} GiB delivered: "
                             f"{st}")
    if on_vs < SCHED_LIMIT:
        raise AssertionError(f"sched: delivery with the scheduler and the "
                             f"breaker on ran {on_vs:.4f} x the engine "
                             f"alone (median of {SCHED_ROUNDS}), below "
                             f"{SCHED_LIMIT}")


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
    streamed0 = strom_torch.stats()["context"]["streamed_transfers"]
    for label in ("64MiB-unstreamed-cold", "64MiB-unstreamed-warm"):
        _timed_delivery(label, lambda: strom_torch.memcpy_ssd2gpu(
            path, length=64 * MiB, device="cuda"), want[:64 * MiB])
    if strom_torch.stats()["context"]["streamed_transfers"] != streamed0:
        raise AssertionError("a 64 MiB read must not be streamed")
    _timed_delivery("1GiB-streamed-sync", lambda: strom_torch.memcpy_ssd2gpu(
        path, device="cuda"), want)
    _timed_delivery("1GiB-streamed-async", lambda: strom_torch.memcpy_wait(
        strom_torch.memcpy_ssd2gpu(path, device="cuda", async_=True)), want)
    st = strom_torch.stats()
    if st["context"]["streamed_transfers"] - streamed0 != 2:
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
    by make_llama_pipeline from the engine): a blocking save, the restore
    into a fresh state and a fresh pipeline
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
    token = pipe.token(ctx)
    if token.consumed != CKPT_STEPS or token.sampler != pipe.state():
        raise AssertionError(f"ckpt: pipe.token() says {token}, the "
                             f"pipeline consumed {CKPT_STEPS}")
    # the state at step k, copied to the host: the roundtrip's reference
    t0 = time.perf_counter()
    host, _ = _host_leaves(tree, snapshot=True)
    snapshot_s = time.perf_counter() - t0
    d1 = os.path.join(workdir, "ckpt_sync")
    before = _write_counts(ctx)
    d2h_us = global_stats.counter("ckpt_d2h_us").value
    t0 = time.perf_counter()
    manifest = save_checkpoint(ctx, d1, tree, extra={TOKEN_KEY:
                                                     token.to_dict()})
    save_s = time.perf_counter() - t0
    d2h_s = (global_stats.counter("ckpt_d2h_us").value - d2h_us) / 1e6
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
    resumed = pipeline().restore(
        StepToken.from_manifest(load_manifest(d1)))
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

    # the pickle baseline runs in phase 13 (cli checkpoint --model small:
    # ckpt_pickle_save_mb_per_s, ckpt_save_vs_pickle); here it is cut to
    # keep the run inside its time
    del host

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
    closed mid-flight and an exact one after it on the same context. The
    file's last phase: it is removed at the end."""
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
        stream_gathers=ctx.stats()["stream"]["stream_gathers"])
    strom_torch.close()
    os.unlink(path)


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
    # the train steps on a context of their own: its steps section covers
    # them alone
    strom_torch.close()
    ctx = strom_torch.init(StromConfig.from_env())
    _drop_cache(tar)
    pipe = make_imagenet_resnet_pipeline(ctx, [tar], batch=128, device=cuda)
    _train_steps("resnet_jpeg", model, step, pipe, JPEG_STEPS)
    pipe.close()
    stall_line("resnet_jpeg", ctx)
    trace_round_trip(workdir)
    strom_torch.close()
    return tar


JPEG_STEPS = 6


def stall_line(arm: str, ctx) -> dict:
    """``goodput_pct`` and each bucket's p50 and p99 from the context's
    steps section (obs/stall.py over the event ring since the context
    started)."""
    steps = ctx.stats()["steps"]
    say("stall", arm=arm, goodput_pct=steps["goodput_pct"],
        steps_observed=steps["steps_observed"],
        **{f"{b}_{q}_us": steps[f"step_{b}_{q}_us"]
           for b in stall.BUCKETS for q in ("p50", "p99")})
    if steps["steps_observed"] < 1:
        raise AssertionError(f"stall {arm}: no step window in the ring")
    return steps


def trace_round_trip(workdir: str) -> None:
    """The event ring as a Chrome trace file, loaded back whole."""
    n = len(events_ring.snapshot())
    path = chrome_trace.dump(os.path.join(workdir, "phase7_trace.json"))
    back = chrome_trace.load_events(path)
    cats = sorted({e["cat"] for e in back if e["ph"] == "X"})
    say("trace", events=n, loaded=len(back), bytes=os.path.getsize(path),
        ring_dropped=events_ring.events_dropped,
        span_cats=",".join(cats))
    if len(back) != n or n == 0:
        raise AssertionError(f"trace: dumped {n} events, loaded {len(back)}")
    os.unlink(path)


NO_JPEG = ("no_cv2_and_no_PIL:_neither_a_JPEG_encoder_for_the_fixture_nor_"
           "the_resize_of_the_train_transform")


# ------------------------------------------------ auto depth and caches
def phase_auto_depth(tar: str | None, model, step, steps: int = 16, *,
                     batch: int = 128, device: str = "cuda") -> None:
    """Phase 7b: the JPEG-fed ResNet pipeline at fixed prefetch depth 2 and
    with prefetch_auto (starting at 2), 1 warm-up and *steps* timed steps
    each: the depth trajectory, timed stalls and step ms per arm. Skipped
    without phase 7's JPEG fixture (*tar* None)."""
    if tar is None:
        say("auto_depth", skipped=NO_JPEG)
        return
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
                dec = ctx.stats(["decode"])["decode"]
                say("decoded_cache", stats=json.dumps(
                    {k: v for k, v in dec.items()
                     if k.startswith("decode_cache")}, sort_keys=True))
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
        decoded0 = global_stats.counter("parquet_decode_bytes").value
        shard = ParquetShard(theirs, ctx=ctx)
        got = [shard.read_row_group_arrays(ctx, g, ["seq", "value", "f0"])
               for g in range(shard.num_row_groups)]
        if global_stats.counter("parquet_decode_bytes").value != decoded0:
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
    st0 = global_stats.snapshot()
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
    st1 = global_stats.snapshot()
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
        st0 = global_stats.snapshot()
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
        st1 = global_stats.snapshot()
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


def phase_parquet(workdir: str, tar: str | None) -> tuple[list[str], dict]:
    """BASELINE config #5 on one H100: the port's PLAIN shards scanned
    into device aggregates, narrow and wide, cold, beside a bare gather of
    the same extents; the pushdown A/B; a striped shard; the OpGraph.
    Returns the shards' paths and numpy's answers over them (the narrow
    count for phase 10, the wide scan's for phase 12b)."""
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
        st0 = global_stats.snapshot()
        t0 = time.perf_counter()
        hits[label] = int(fn()["hits"])
        rates[label] = PQ_SHARDS * PQ_ROWS / (time.perf_counter() - t0)
        if label == "pushed":
            st1 = global_stats.snapshot()
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
        return paths, ref
    # the reference test's graph on phase 7's tar: fused and streamed
    # against unfused, batches bit-equal
    runs = {}
    for fuse in (True, False):
        gctx = StromContext(StromConfig.from_env())
        ops0 = global_stats.snapshot()
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
        ops = {k: v - ops0.get(k, 0)
               for k, v in global_stats.snapshot().items()
               if k.startswith("ops_") and v != ops0.get(k, 0)}
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
    return paths, ref


# ------------------------------------------------------- spill (7e)
SPILL_RECORD_TOKENS = 1024           # the reference arm's records: 4 KiB
SPILL_PREAD_BYTES = 128 * MiB        # the epoch pair's token shard
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
    """The reference's spill epoch pair (at SPILL_PREAD_BYTES of *toks*): the token
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
    reference's epoch pair at SPILL_PREAD_BYTES, spill_compress off then
    on. arm=resnet:
    BASELINE config #2's predecoded shard into ResNet-50 for 3 epochs with
    hot_cache_bytes 64 MiB, admission "always" and a 1 GiB spill file,
    against the same run with no cache: batches and losses bit-equal, and
    no source misses from epoch 2 on."""
    toks = np.random.default_rng(7).integers(0, 1 << 15, SPILL_PREAD_BYTES // 4,
                                             dtype=np.int32)
    # the epoch pair runs at 128 MiB (the reference's 1 GiB, cut) to keep
    # the script inside its time
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


@contextlib.contextmanager
def _env(**kv):
    """STROM_* switches for one CLI call (its config honours them)."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_multitenant(workdir: str, pdec: str,
                      pq: tuple[list[str], dict]) -> None:
    """Phase 10: strom_torch.cli.bench_multitenant at full width on one
    context with three registered tenants: llama (training; phase 4's
    shards into the captured flash step, Llama-3-8B widths, 2 layers, batch
    2 x 2048, from a fresh state of one seed: 2 warm-up and capture steps,
    then 16 timed), vis0 (training; the predecoded ResNet-50 loader alone,
    batch 128 x 224^2) and pq (interactive; phase 9's narrow scan,
    repeated). Each solo, then the three concurrently on threads; then the
    same with the scheduler off (STROM_SCHED_ENABLED=0). Concurrent Llama
    losses equal the solo run's bit for bit, every pq count is exact, and
    the llama tenant launches the three sm90 kernels."""
    pq_paths, pq_hits = pq[0], pq[1]["hits"]
    cuda = torch.device("cuda")
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    tok_paths = [os.path.join(workdir, f"tokens{i}.bin") for i in range(2)]
    for p in tok_paths + [pdec] + pq_paths:
        if not os.path.exists(p):
            raise AssertionError(f"multitenant: fixture {p} is gone")
    side: dict[str, list] = {"losses": [], "llama": []}

    def make(ctx):
        def llama(tenant: str) -> float:
            pipe = make_llama_pipeline(
                ctx, tok_paths, batch=2, seq_len=2047, device="cuda", seed=0,
                scope={"pipeline": "llama", "tenant": tenant})
            state = init_train_state(cfg, device="cuda", seed=0)
            step = make_train_step(cfg, attn="flash", device="cuda")
            losses = []
            try:
                for _ in range(2):   # the warm-up and the capture
                    state, m = step(state, next(pipe))
                    losses.append(m["loss"])
                torch.cuda.current_stream().synchronize()
                stalls0 = pipe.data_stall_steps
                t0 = time.perf_counter()
                for _ in range(MT_LLAMA_STEPS):
                    state, m = step(state, next(pipe))
                    losses.append(m["loss"])
                torch.cuda.current_stream().synchronize()
                dt = time.perf_counter() - t0
                if step.last_call != "replay":
                    raise AssertionError("multitenant llama: the timed "
                                         "steps did not replay the graph")
                side["losses"].append(torch.stack(losses).cpu())
                side["llama"].append(
                    {"step_ms": f"{dt / MT_LLAMA_STEPS * 1e3:.2f}",
                     "stalls": pipe.data_stall_steps - stalls0})
                return MT_LLAMA_STEPS * 2 * 2048 / dt
            finally:
                pipe.close()
                del state, step

        def vis(tenant: str) -> float:
            pipe = make_predecoded_vision_pipeline(
                ctx, [pdec], batch=128, image_size=IMAGE, device=cuda,
                scope={"pipeline": "resnet", "tenant": tenant})
            try:
                next(pipe)
                t0 = time.perf_counter()
                for _ in range(MT_VIS_BATCHES):
                    imgs, _lbls = next(pipe)
                torch.cuda.current_stream().synchronize()
                return MT_VIS_BATCHES * 128 / (time.perf_counter() - t0)
            finally:
                pipe.close()

        def pq(tenant: str) -> float:
            t0 = time.perf_counter()
            counts = [parquet_count_where(
                ctx, pq_paths, "value", lambda v: v > 0,
                scope={"pipeline": "parquet", "tenant": tenant})
                for _ in range(MT_PQ_SCANS)]
            dt = time.perf_counter() - t0
            if any(c != pq_hits for c in counts):
                raise AssertionError(f"multitenant pq: counts {counts} "
                                     f"against {pq_hits}")
            return MT_PQ_SCANS * PQ_SHARDS * PQ_ROWS / dt

        if ctx.scheduler is not None:
            side["slice_bytes"] = [ctx.scheduler._slice_bytes()]
            say("multitenant", exclusive=ctx.scheduler.exclusive,
                slice_bytes=side["slice_bytes"][0],
                engine=ctx.engine.stats()["engine"])
        return [("llama", "training", llama), ("vis0", "training", vis),
                ("pq", "interactive", pq)]

    say("multitenant", tenants="llama:training,vis0:training,pq:interactive",
        llama_steps=MT_LLAMA_STEPS, vis_batches=MT_VIS_BATCHES,
        pq_scans=MT_PQ_SCANS, via="strom_torch.cli.bench_multitenant")
    base = StromConfig()   # the engine shapes of the other phases
    args = cli.build_parser().parse_args([
        "multitenant", "--json", "--tmpdir", workdir,
        "--steps", str(MT_LLAMA_STEPS), "--batch", "128",
        "--image-size", str(IMAGE), "--block", str(base.block_size),
        "--depth", str(base.queue_depth)])
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli.bench_multitenant(args, workloads=make)
    wall = time.perf_counter() - t0
    launches = check_variants(KERNELS, dict(fa.VARIANT_LAUNCHES),
                              "multitenant llama tenant")
    rate = ENGINE_ALONE_GBPS[-1] if ENGINE_ALONE_GBPS else 2.0
    slice_s = side["slice_bytes"][0] / (rate * 1e9)
    for name in out["mt_tenants"]:
        pre = f"mt_{name}_"
        say("multitenant", arm="solo", tenant=name,
            items_per_s=out[pre + "solo_items_per_s"],
            **(side["llama"][0] if name == "llama" else {}))
        say("multitenant", arm="concurrent", tenant=name,
            **{k[len(pre):]: v for k, v in out.items()
               if k.startswith(pre) and not k.endswith("solo_items_per_s")},
            **(side["llama"][1] if name == "llama" else {}))
    say("multitenant", arm="concurrent", wall_s=out["concurrent_wall_s"],
        mt_vs_solo_mean=out["mt_vs_solo_mean"],
        llama_data_stalls_timed=side["llama"][1]["stalls"],
        pq_queue_wait_p99_us=out["mt_pq_sched_queue_wait_p99_us"],
        one_slice_us=f"{slice_s * 1e6:.0f}", one_slice_at_gbps=f"{rate:.3f}",
        launches=json.dumps(launches, sort_keys=True),
        s=f"{wall:.2f}")
    solo_l, conc_l = side["losses"][:2]
    if not torch.equal(conc_l, solo_l):
        raise AssertionError(f"multitenant: concurrent llama losses "
                             f"{conc_l.tolist()} differ from solo "
                             f"{solo_l.tolist()}")
    say("multitenant", check="concurrent llama losses equal solo, pq "
        "counts exact", exact=True,
        last_losses=",".join(f"{x:.6f}" for x in conc_l.tolist()[-4:]))
    torch.cuda.empty_cache()
    with _env(STROM_SCHED_ENABLED=0):
        off = cli.bench_multitenant(args, workloads=make)
    say("multitenant", arm="concurrent_sched_off",
        sched_enabled=off["sched_enabled"],
        wall_s=off["concurrent_wall_s"],
        **{f"{n}_items_per_s": off[f"mt_{n}_items_per_s"]
           for n in off["mt_tenants"]},
        **{f"{n}_vs_solo": off[f"mt_{n}_vs_solo"] for n in off["mt_tenants"]},
        llama_data_stalls_timed=side["llama"][3]["stalls"])
    if off["sched_enabled"] or not torch.equal(side["losses"][3], solo_l):
        raise AssertionError("multitenant: with the scheduler off the llama "
                             "losses differ from the solo run's (or the "
                             "scheduler was on)")
    torch.cuda.empty_cache()


# ----------------------------------------------------- resilience (11)
CHAOS_BATCHES = 4
CHAOS_BATCH = 128
BREAKER_BYTES = 256 * MiB
# the drain grace after a deadline miss (strom_torch/engine/base.py's
# read_vectored: min(engine_wait_timeout_s, 1.0))
DEADLINE_GRACE_S = 1.0


def _resil_counts() -> dict:
    """The process-wide resilience counters (RESILIENCE_FIELDS)."""
    return {k: global_stats.counter(k).value for k in RESILIENCE_FIELDS
            if k != "breaker_state"}


def _chaos_arm(arm: str, path: str, make_pipe) -> None:
    """strom_torch.cli.bench_chaos over *make_pipe*'s loader: CHAOS_BATCHES
    batches clean, then under chaos:0, each pass on a fresh context under
    the lock-order witness with the residency hybrid off (and io_retries 3
    through STROM_IO_RETRIES), its stall buckets printed before it closes;
    the faulted pass must finish with the clean pass's batches, and no
    lock-order cycle may show."""
    cycles0 = locks.witness.cycles
    cfg = StromConfig()
    args = cli.build_parser().parse_args([
        "chaos", "--json", "--file", path, "--batch", str(CHAOS_BATCH),
        "--image-size", str(IMAGE), "--steps", str(CHAOS_BATCHES),
        "--block", str(cfg.block_size), "--depth", str(cfg.queue_depth),
        "--seed", "0"])

    def on_pass(plan: str, ctx) -> None:
        stall_line(f"chaos_{arm}_{'faulty' if plan else 'clean'}", ctx)

    with _env(STROM_IO_RETRIES=3):
        res = cli.bench_chaos(args, make_pipe=make_pipe, on_pass=on_pass)
    out = {k: res[k] for k in CHAOS_BENCH_FIELDS}
    cycles = locks.witness.cycles - cycles0
    say("chaos", arm=arm, fault_plan=res["fault_plan"],
        batches=CHAOS_BATCHES, batch=CHAOS_BATCH, **out, debug_locks=True,
        lock_order_cycles=cycles, hedges_won=res["hedges_won"],
        retry_backoff_waits=res["retry_backoff_waits"],
        retry_budget_exhausted=res["retry_budget_exhausted"],
        via="strom_torch.cli.bench_chaos")
    if out["chaos_ok"] != 1 or out["chaos_faults_injected"] <= 0 or cycles:
        raise AssertionError(f"chaos {arm}: batches under chaos:0 differ "
                             f"from the clean pass's, no fault was "
                             f"injected ({out['chaos_faults_injected']}), "
                             f"or the witness saw {cycles} lock-order "
                             f"cycle(s)")


def _breaker_arm(path: str, want: torch.Tensor) -> None:
    """memcpy_ssd2gpu of 256 MiB with the engine dead from op 16: the
    gather that fails trips the breaker (breaker_min_events=1) and is read
    by the fallback engine; the next delivery goes straight there. Both
    deliver to *want*'s device."""
    plan = json.dumps({"seed": 0, "rules": [{"kind": "engine_death",
                                             "op_lo": 16}]})
    cfg = StromConfig.from_env(residency_hybrid=False, fault_plan=plan,
                               breaker_min_events=1, breaker_cooldown_s=60.0)
    ctx = StromContext(cfg)
    try:
        before = _resil_counts()
        t0 = time.perf_counter()
        got = ctx.memcpy_ssd2gpu(path, device=want.device)
        if got.is_cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d = {k: v - before[k] for k, v in _resil_counts().items()}
        st = ctx.stats()
        landed = 16 * ctx.config.block_size
        exact = torch.equal(got, want)
        say("breaker", bytes=BREAKER_BYTES, death_at_op=16,
            breaker_min_events=1, s=f"{dt:.3f}",
            gbps=f"{BREAKER_BYTES / dt / 1e9:.3f}", exact=exact,
            breaker_trips=d["breaker_trips"],
            failover_reads=d["failover_reads"],
            failover_bytes=d["failover_bytes"],
            chunk_retries=d["chunk_retries"],
            state=st["resilience"]["state"],
            engine_dead=st["resilience"]["fault_plan"]["engine_dead"])
        if not exact or d["breaker_trips"] < 1 \
                or d["failover_bytes"] < BREAKER_BYTES - landed:
            raise AssertionError("breaker: the delivery over a dead engine "
                                 "was not exact, tripped nothing, or the "
                                 "fallback did not cover the rest")
        ops = ctx.engine.plan.stats()["ops_seen"]
        before = _resil_counts()
        got = ctx.memcpy_ssd2gpu(path, length=64 * MiB, device=want.device)
        d = {k: v - before[k] for k, v in _resil_counts().items()}
        straight = ctx.engine.plan.stats()["ops_seen"] == ops
        exact = torch.equal(got, want[:64 * MiB])
        say("breaker", arm="while_open", bytes=64 * MiB, exact=exact,
            primary_ops=ctx.engine.plan.stats()["ops_seen"] - ops,
            failover_bytes=d["failover_bytes"], straight_to_fallback=straight)
        if not (exact and straight and d["failover_bytes"] == 64 * MiB):
            raise AssertionError("breaker: a delivery while the breaker is "
                                 "open touched the primary or was not exact")
    finally:
        ctx.close()


def _deadline_arm(path: str) -> None:
    """A pread under a 0.5 s latency on every read with deadline_s=0.05
    raises DeadlineExceeded within the deadline plus the drain grace; a
    tenant queued behind a held grant leaves the queue at its deadline."""
    plan = json.dumps({"seed": 0, "rules": [{"kind": "latency",
                                             "latency_s": 0.5}]})
    ctx = StromContext(StromConfig.from_env(residency_hybrid=False,
                                            fault_plan=plan))
    try:
        before = _resil_counts()
        t0 = time.perf_counter()
        raised = None
        try:
            ctx.pread(path, 0, 4 * MiB, deadline_s=0.05)
        except DeadlineExceeded as e:
            raised = e
        dt = time.perf_counter() - t0
        d = {k: v - before[k] for k, v in _resil_counts().items()}
        ok = raised is not None and dt < 0.05 + DEADLINE_GRACE_S
        say("deadline", arm="latency", latency_s=0.5, deadline_s=0.05,
            raised=type(raised).__name__ if raised else "nothing",
            s_to_raise=f"{dt:.4f}", bound_s=0.05 + DEADLINE_GRACE_S,
            deadline_exceeded=d["deadline_exceeded"], within_bound=ok)
        if not ok or d["deadline_exceeded"] < 1:
            raise AssertionError(f"deadline: pread raised {raised!r} after "
                                 f"{dt:.3f} s")
    finally:
        ctx.close()
    ctx = StromContext(StromConfig.from_env())
    try:
        sched = ctx.scheduler
        ctx.register_tenant("holder")
        ctx.register_tenant("late")
        w = sched.acquire("holder", 1)
        got: dict = {}

        def late() -> None:
            t = time.perf_counter()
            try:
                ctx.pread(path, 0, MiB, tenant="late", deadline_s=0.2)
            except DeadlineExceeded as e:
                got["e"] = e
            got["s"] = time.perf_counter() - t

        th = threading.Thread(target=late)
        th.start()
        th.join(10.0)
        queued = len(sched.tenant("late").queue)
        sched.release(w)
        ok = isinstance(got.get("e"), DeadlineExceeded) \
            and 0.2 <= got["s"] < 0.2 + DEADLINE_GRACE_S and queued == 0
        say("deadline", arm="queued_behind_grant", deadline_s=0.2,
            raised=type(got.get("e")).__name__,
            s_to_dequeue=f"{got.get('s', -1):.4f}", left_queued=queued,
            dequeued_at_deadline=ok)
        if not ok:
            raise AssertionError(f"deadline: the queued tenant was not "
                                 f"dequeued at its deadline: {got}")
    finally:
        ctx.close()


def _resume_arm(workdir: str) -> None:
    """strom_torch.cli.bench_resume with --model tiny and one async save
    (its phase 1 on the card), then run_kill_resume(seed=1): three trainer
    processes (the reference run, one SIGKILLed mid-epoch, the restart).
    resume_ok folds the harness's checks (the restart serial, the batch
    stream, no tmp checkpoint left) and must be 1; the async checkpoint's
    round trip must be exact."""
    t0 = time.perf_counter()
    out = cli.bench_resume(cli.build_parser().parse_args([
        "resume", "--json", "--tmpdir", workdir, "--model", "tiny",
        "--saves", "1", "--seed", "1", "--signal", "KILL"]))
    dt = time.perf_counter() - t0
    say("resume", **{k: out[k] for k in RESUME_FIELDS},
        ckpt_async_roundtrip_ok=out["ckpt_async_roundtrip_ok"],
        ckpt_async_stall_frac=out["ckpt_async_stall_frac"],
        harness_s=f"{dt:.2f}", failures=json.dumps(
            out.get("resume_failures", [])),
        via="strom_torch.cli.bench_resume")
    if out["resume_ok"] != 1 or out["ckpt_async_roundtrip_ok"] != 1:
        raise AssertionError(f"resume: {out.get('resume_failures')}, "
                             f"async round trip "
                             f"{out['ckpt_async_roundtrip_ok']}")


def _handle_arm(path: str, want: torch.Tensor) -> None:
    """block_until_ready(), then the tensor read on a fresh stream with no
    synchronize: exact."""
    ctx = StromContext(StromConfig.from_env())
    try:
        for length in (64 * MiB, BREAKER_BYTES):
            h = ctx.memcpy_ssd2gpu(path, length=length, async_=True)
            t = h.block_until_ready()
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                host = t.to("cpu")
            exact = torch.equal(host, want[:length].cpu())
            say("handle", bytes=length, exact=exact,
                elapsed_s=f"{h.elapsed_s:.4f}",
                events=len(h._ready), exception=h.exception())
            if not exact or not h._ready:
                raise AssertionError("handle: the tensor read on a fresh "
                                     "stream after block_until_ready() "
                                     "differs from the file")
    finally:
        ctx.close()


def _slab_leak_arm(path: str, want: torch.Tensor) -> None:
    """A failed streamed delivery on pinned slabs keeps none: 256 MiB
    through memcpy_ssd2gpu (two 128 MiB pieces) where the read op over one
    byte of the second piece fails twice, once more than io_retries, with
    the breaker off, so the delivery raises. slab_in_use_bytes must read 0
    after the raise; a clean delivery follows in the same context, and
    another in a new context after this one closed (a registration that
    outlived its pool would make that one's cudaHostRegister fail)."""
    off = BREAKER_BYTES - BREAKER_BYTES // 8
    plan = json.dumps({"seed": 0, "rules": [
        {"kind": "errno", "op": "read", "offset_lo": off,
         "offset_hi": off + 1, "times": 2}]})
    cfg = dict(residency_hybrid=False, io_retries=1, breaker_enabled=False)
    ctx = StromContext(StromConfig.from_env(fault_plan=plan, **cfg))
    try:
        raised = None
        try:
            ctx.memcpy_ssd2gpu(path, device=want.device)
        except EngineError as e:
            raised = e
        pool = ctx.stats()["slab_pool"]
        t0 = time.perf_counter()
        got = ctx.memcpy_ssd2gpu(path, device=want.device)
        if got.is_cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        exact = torch.equal(got, want)
        del got
        say("slab_leak", bytes=BREAKER_BYTES, failed_at=off,
            raised=type(raised).__name__ if raised else "nothing",
            slab_in_use_bytes=pool["slab_in_use_bytes"],
            parked_bytes=pool["parked_bytes"],
            registered_slabs=pool["registered_slabs"],
            streamed_transfers=ctx.stats()["context"]["streamed_transfers"],
            clean_exact=exact, clean_gbps=f"{BREAKER_BYTES / dt / 1e9:.3f}")
        if raised is None or pool["slab_in_use_bytes"] != 0 or not exact:
            raise AssertionError(f"slab_leak: raised {raised!r}, "
                                 f"{pool['slab_in_use_bytes']} bytes of slabs "
                                 f"still out, clean delivery exact={exact}")
    finally:
        ctx.close()
    left = ctx._slab_pool.stats()["registered_slabs"]
    with StromContext(StromConfig.from_env(**cfg)) as again:
        got = again.memcpy_ssd2gpu(path, device=want.device)
        exact = torch.equal(got, want)
        del got
    say("slab_leak", arm="new_context", registered_after_close=left,
        exact=exact)
    if left or not exact:
        raise AssertionError(f"slab_leak: {left} slab(s) registered after "
                             f"close, or the new context's delivery "
                             f"differs")


HEDGE_BYTES = 64 * MiB
HEDGE_HOLD_S = 0.5


def _hedge_arm(path: str, want: torch.Tensor) -> None:
    """A 64 MiB streamed gather (StreamingGather into a pinned slab) whose
    read op 8 is held 0.5 s by a latency rule, once with hedges off and
    once on: both exact; with hedges on the held chunk is re-read on the
    fallback engine and wins."""
    plan = json.dumps({"seed": 0, "rules": [
        {"kind": "latency", "op": "read", "op_lo": 8, "op_hi": 9,
         "latency_s": HEDGE_HOLD_S}]})
    host = want[:HEDGE_BYTES].cpu().numpy()
    for hedge in (False, True):
        ctx = StromContext(StromConfig.from_env(
            residency_hybrid=False, fault_plan=plan, hedge_enabled=hedge))
        try:
            dest = ctx.host_batch((HEDGE_BYTES,), want.device)
            before = _resil_counts()
            t0 = time.perf_counter()
            g = ctx.stream_segments(path, [Segment(0, 0, HEDGE_BYTES)], dest)
            try:
                while not g.done:
                    g.poll(min_completions=1, timeout_s=1.0)
                g.finish()
            finally:
                g.close()
            dt = time.perf_counter() - t0
            d = {k: v - before[k] for k, v in _resil_counts().items()}
            exact = bool(np.array_equal(dest, host))
            thr = ctx.stats()["resilience"].get("hedge_threshold_us")
            ctx.release_host_batch(dest, want.device)
            say("hedge", hedge_enabled=hedge, bytes=HEDGE_BYTES,
                held_op=8, hold_s=HEDGE_HOLD_S, s=f"{dt:.4f}",
                gbps=f"{HEDGE_BYTES / dt / 1e9:.3f}", exact=exact,
                hedges_fired=d["hedges_fired"], hedges_won=d["hedges_won"],
                hedge_wasted_bytes=d["hedge_wasted_bytes"],
                hedge_threshold_us=thr)
            if not exact or (hedge and (d["hedges_fired"] < 1
                                        or d["hedges_won"] < 1)) \
                    or (not hedge and d["hedges_fired"]):
                raise AssertionError(f"hedge: exact={exact}, hedges {d}")
        finally:
            ctx.close()


QUARANTINE_RECOVERY_S = 0.5


def _quarantine_arm(workdir: str) -> None:
    """Two files over a 2-ring engine whose ring 0 fails every read of its
    file with EIO (a fault plan on that ring): gathers fail until ring 0
    is quarantined, then the file routes to ring 1, exact; after
    ring_recovery_s the rebuilt ring serves again, exact. Needs io_uring;
    elsewhere the arm says why it is skipped."""
    if not uring_engine.uring_available():
        say("quarantine", skipped=uring_engine.unavailable_reason
            .replace(" ", "_") or "io_uring_unavailable")
        return
    from strom_torch.engine.multi import MultiRingEngine

    n = 16 * MiB
    rng = np.random.default_rng(17)
    files = []
    for i in range(2):
        p = os.path.join(workdir, f"ring{i}.bin")
        d = rng.integers(0, 256, n, dtype=np.uint8)
        _write_file(p, d)
        files.append((p, d))
    eng = MultiRingEngine(StromConfig.from_env(
        engine_rings=2, breaker_min_events=2, io_retries=0,
        ring_recovery_s=QUARANTINE_RECOVERY_S))
    plan = FaultPlan.from_spec(json.dumps(
        {"seed": 0, "rules": [{"kind": "errno", "op": "read",
                               "path": "ring0.bin"}]}))
    eng._children[0] = FaultyEngine(eng._children[0], plan)
    try:
        fis = [eng.register_file(p) for p, _ in files]
        chunks = [(fis[0], 0, 0, n), (fis[1], 0, n, n)]
        want = np.concatenate([d for _, d in files])
        dest = alloc_aligned(2 * n)
        failed = 0
        while failed < 4 and not eng.stats()["quarantined_rings"]:
            try:
                eng.read_vectored(chunks, dest)
            except EngineError:
                failed += 1
        quarantined = eng.stats()["quarantined_rings"]
        exact = eng.read_vectored(chunks, dest) == 2 * n \
            and np.array_equal(dest, want)
        time.sleep(QUARANTINE_RECOVERY_S)
        dest[:] = 0
        recovered = eng.read_vectored(chunks, dest) == 2 * n \
            and np.array_equal(dest, want)
        st = eng.stats()
        say("quarantine", rings=2, failed_gathers=failed,
            quarantined_rings=json.dumps(quarantined).replace(" ", ""),
            exact_degraded=exact, ring_recoveries=st["ring_recoveries"],
            exact_recovered=recovered,
            ring0_ops=st["ring_stats"][0]["ops_submitted"])
        if quarantined != [0] or not exact or not recovered \
                or st["ring_recoveries"] != 1:
            raise AssertionError(
                f"quarantine: {quarantined}, exact {exact}, recovered "
                f"{recovered}, {st['ring_recoveries']} recoveries")
    finally:
        eng.close()
        for p, _ in files:
            os.unlink(p)


def _stress_arm() -> None:
    """The stress harness on the card's default engine under the witness:
    readers, a stats poller and a dest registrar over one context."""
    from strom_torch.engine.stress import run_stress

    cycles0 = locks.witness.cycles
    was_on = locks.witness_enabled()
    locks.enable_witness(True)
    t0 = time.perf_counter()
    try:
        rc = run_stress("", seconds=3)
    finally:
        locks.enable_witness(was_on)
    cycles = locks.witness.cycles - cycles0
    say("stress", rc=rc, seconds=3, debug_locks=True,
        lock_order_cycles=cycles, wall_s=f"{time.perf_counter() - t0:.2f}")
    if rc != 0 or cycles:
        raise AssertionError(f"stress: rc {rc}, {cycles} lock-order cycles")


def _flight_arm(workdir: str, path: str, device: torch.device) -> None:
    """A context with flight_dir: one delivery, capture("on_demand"), then
    a dumped bundle loaded back with stats, stacks and a trace."""
    fdir = os.path.join(workdir, "flight")
    ctx = StromContext(StromConfig.from_env(flight_dir=fdir,
                                            flight_stall_s=0.0))
    try:
        ctx.memcpy_ssd2gpu(path, length=16 * MiB, device=device)
        rec = ctx.flight_recorder
        cap = rec.capture("on_demand")
        b = load_bundle(rec.dump("on_demand", note="chip_smoke"))
        ok = bool(b["stats"].get("sections")) and "thread" in b["stacks"] \
            and len(b["trace"]["traceEvents"]) > 0 \
            and b["manifest"]["fields"] == cap["fields"]
        say("flight", capture_samples=len(cap["samples"]),
            bundle_trace_events=len(b["trace"]["traceEvents"]),
            stacks_bytes=len(b["stacks"]),
            sections=len(b["stats"].get("sections", {})),
            slab_in_use_bytes=cap["samples"][-1]["slab_in_use_bytes"],
            round_trip=ok)
        if not ok:
            raise AssertionError("flight: the bundle lacks stats, stacks "
                                 "or a trace")
    finally:
        ctx.close()
    shutil.rmtree(fdir, ignore_errors=True)


def phase_resilience(workdir: str, pdec: str, tar: str | None) -> None:
    """Phase 11: the chaos arms (under the lock-order witness, with their
    stall buckets), the breaker, deadlines, the handle's barrier, the
    failed delivery's slabs, hedged reads, ring quarantine, the stress
    harness, the flight recorder and kill-and-resume."""
    cuda = torch.device("cuda")
    if tar is None:
        say("chaos", arm="jpeg", skipped=NO_JPEG)
    else:
        _chaos_arm("jpeg", tar, lambda ctx: make_imagenet_resnet_pipeline(
            ctx, [tar], batch=CHAOS_BATCH, device=cuda))
    _chaos_arm("predecoded", pdec,
               lambda ctx: make_predecoded_vision_pipeline(
                   ctx, [pdec], batch=CHAOS_BATCH, image_size=IMAGE,
                   device=cuda))
    path = os.path.join(workdir, "resilience.bin")
    data = np.random.default_rng(11).integers(0, 256, BREAKER_BYTES,
                                              dtype=np.uint8)
    _write_file(path, data)
    want = torch.from_numpy(data).to(cuda)
    _breaker_arm(path, want)
    _deadline_arm(path)
    _handle_arm(path, want)
    _slab_leak_arm(path, want)
    _hedge_arm(path, want)
    _flight_arm(workdir, path, cuda)
    del want
    os.unlink(path)
    _quarantine_arm(workdir)
    _stress_arm()
    _resume_arm(workdir)


# ---------------------------------------------------- observability (12)
OBS_STEPS = 16            # Llama steps an arm: warm-up, capture, replays
SCRAPE_HZ = 20            # the [server] loop's /metrics?sections= rate
SCRAPE_LOOP = "/metrics?sections=context,sched"
ROUTES = ("/metrics", "/stats", "/trace", "/trace?cat=sched",
          "/trace?since_us=x", "/slo", "/tune", "/history", "/tenants",
          "/flight", "/cluster")
# the documented answers other than 200 on a context with no tuner and no
# cluster view, and on a malformed filter
ROUTE_CODES = {"/tune": 404, "/cluster": 404, "/trace?since_us=x": 400}
FED_STALE_S, FED_INTERVAL_S = 1.0, 0.2
# the registry counters the [federation] check sums host by host (a gauge
# such as engine_inflight moves between two scrapes)
FED_SUM_KEYS = ("ssd2gpu_bytes", "sched_granted_bytes", "sched_granted_ops",
                "engine_op_lat_count")
TUNE_BEATS, TUNE_BEAT_S = 4, 2.05   # a beat outlasts the steps TTL (2 s)
OBS_LLAMA = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
OBS_B, OBS_SEQ = 2, 2047


def _http(port: int, route: str) -> tuple[int, bytes, float]:
    """GET *route*: (status, body, ms)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=30) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, (time.perf_counter() - t0) * 1e3


class _Scraper(threading.Thread):
    """Each of *routes* once, then SCRAPE_LOOP at SCRAPE_HZ until
    stopped."""

    def __init__(self, port: int, routes=ROUTES) -> None:
        super().__init__(name="chip-smoke-scraper", daemon=True)
        self.port = port
        self.first = routes
        self.stop = threading.Event()
        self.routes: dict[str, tuple[int, int, float]] = {}
        self.loop: list[tuple[int, float]] = []
        self.metrics_text = b""

    def run(self) -> None:
        for r in self.first:
            code, body, ms = _http(self.port, r)
            self.routes[r] = (code, len(body), ms)
            if r == "/metrics":
                self.metrics_text = body
        while not self.stop.wait(1.0 / SCRAPE_HZ):
            code, _, ms = _http(self.port, SCRAPE_LOOP)
            self.loop.append((code, ms))


def _obs_llama_arm(ctx, paths: list[str], cfg, scraped: bool, B: int,
                   seq_len: int) -> tuple[list, float, "_Scraper | None"]:
    """OBS_STEPS captured flash steps on a fresh state and pipeline (seed
    0): the losses and grad norms, the median replay ms, and the scraper
    that ran beside them."""
    pipe = make_llama_pipeline(ctx, paths, batch=B, seq_len=seq_len,
                               device="cuda", seed=0)
    state = init_train_state(cfg, device="cuda", seed=0)
    step = make_train_step(cfg, attn="flash", device="cuda")
    scraper = _Scraper(ctx.metrics_server.port) if scraped else None
    if scraper is not None:
        scraper.start()
    metrics, times = [], []
    try:
        for _ in range(OBS_STEPS):
            batch = next(pipe)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
            times.append((time.perf_counter() - t0, step.last_call))
    finally:
        if scraper is not None:
            scraper.stop.set()
            scraper.join()
        pipe.close()
    if step.graphs != 1 or step.last_call != "replay":
        raise AssertionError(f"server: the captured step ran {step.graphs} "
                             f"graphs, last call {step.last_call}")
    replay = statistics.median(t for t, c in times[2:])
    del state, step
    torch.cuda.empty_cache()
    return metrics, replay * 1e3, scraper


def _server_arm(ctx, workdir: str) -> None:
    """[server]: the Llama step at the main path's widths, captured and
    replayed, with a scraper on the live endpoint and without, alternating
    (off, on, on, off); every route's status and ms; losses equal."""
    cfg, B, seq_len, records = OBS_LLAMA, OBS_B, OBS_SEQ, 2 * OBS_STEPS
    rng = np.random.default_rng(12)
    paths = []
    for i in range(2):
        paths.append(os.path.join(workdir, f"obs_tokens{i}.bin"))
        write_token_shard(ctx, paths[-1], rng.integers(
            0, cfg.vocab, (records, seq_len + 1), dtype=np.int32))
    runs = []
    for scraped in (False, True, True, False):
        metrics, ms, scraper = _obs_llama_arm(ctx, paths, cfg, scraped, B,
                                              seq_len)
        runs.append((scraped, metrics, ms))
        say("server", scraper="on" if scraped else "off", steps=OBS_STEPS,
            step_ms_replay_median=f"{ms:.2f}",
            loss_last=f"{metrics[-1][0]:.5f}")
        if scraper is None:
            continue
        for r, (code, nbytes, rms) in scraper.routes.items():
            say("server", route=r, status=code, bytes=nbytes, ms=f"{rms:.2f}")
            if code != ROUTE_CODES.get(r, 200):
                raise AssertionError(f"server: {r} answered {code}")
        loop_ms = sorted(ms_ for _, ms_ in scraper.loop)
        bad = [c for c, _ in scraper.loop if c != 200]
        lines = scraper.metrics_text.decode().splitlines()
        say("server", loop=SCRAPE_LOOP, hz=SCRAPE_HZ,
            scrapes=len(scraper.loop),
            ms_p50=f"{loop_ms[len(loop_ms) // 2]:.2f}" if loop_ms else "-",
            ms_max=f"{loop_ms[-1]:.2f}" if loop_ms else "-",
            metrics_lines=len(lines), metrics_bytes=len(scraper.metrics_text),
            non_200=len(bad))
        if bad or not scraper.loop:
            raise AssertionError(f"server: loop scrapes {len(scraper.loop)}, "
                                 f"non-200 {bad[:5]}")
    want = runs[0][1]
    for scraped, metrics, _ in runs[1:]:
        if metrics != want:
            raise AssertionError(f"server: losses with the scraper "
                                 f"{'on' if scraped else 'off'} differ from "
                                 "the unscraped run's")
    on = [ms for sc, _, ms in runs if sc]
    off = [ms for sc, _, ms in runs if not sc]
    say("server", check="losses and grad norms equal across the four arms",
        exact=True, step_ms_on=",".join(f"{v:.2f}" for v in on),
        step_ms_off=",".join(f"{v:.2f}" for v in off),
        on_over_off=f"{statistics.mean(on) / statistics.mean(off):.4f}")
    for p in paths:
        os.unlink(p)


def _server_loader_arm(tar: str | None) -> None:
    """[server] loader: the JPEG ResNet loader alone, 4 batches of 128 from
    a dropped page cache, on a context with the live server, the history
    and the 20 Hz scraper, and on one with none of them, alternating
    (off, on, on, off): the host threads they add share the interpreter
    lock with the loader's."""
    if tar is None:
        say("server", loader="jpeg", skipped=NO_JPEG)
        return
    cuda = torch.device("cuda")
    rates = {False: [], True: []}
    for on in (False, True, True, False):
        ctx = StromContext(StromConfig.from_env(history_interval_s=0.5),
                           metrics_port=0 if on else None)
        scraper = _Scraper(ctx.metrics_server.port, routes=()) if on else None
        try:
            _drop_cache(tar)
            pipe = make_imagenet_resnet_pipeline(ctx, [tar], batch=128,
                                                 device=cuda)
            if scraper is not None:
                scraper.start()
            t0 = time.perf_counter()
            for _ in range(4):
                next(pipe)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            pipe.close()
        finally:
            if scraper is not None:
                scraper.stop.set()
                scraper.join()
            ctx.close()
        rates[on].append(4 * 128 / dt)
        say("server", loader="jpeg", scraper_and_history="on" if on else "off",
            images_per_s=f"{rates[on][-1]:.1f}",
            scrapes=len(scraper.loop) if scraper else 0)
    on, off = statistics.mean(rates[True]), statistics.mean(rates[False])
    say("server", loader="jpeg", on_over_off=f"{on / off:.4f}")


def _slo_arm(ctx, path: str) -> None:
    """[slo]: two tenants on one context, one with a gather target under
    half its own engine ops' p50 (a gather waits for its slowest op, so
    most of its reads miss it): it burns on /slo and on its /tenants row,
    the other does not."""
    port = ctx.metrics_server.port
    ctx.register_tenant("slo_tight")
    ctx.register_tenant("slo_loose")
    for t in ("slo_tight", "slo_loose"):
        for i in range(16):
            ctx.pread(path, i * MiB, MiB, tenant=t)
    # the tenant's own scope: the process-wide histogram holds every
    # earlier phase's ops
    p50 = global_stats.scoped(tenant="slo_tight").histogram(
        "engine_op_lat").percentile(0.5)
    ctx.slo.set_target("slo_tight", gather_p99_us=max(p50 / 2, 1.0))
    for i in range(16):
        ctx.pread(path, i * MiB, MiB, tenant="slo_tight")
    code, body, ms = _http(port, "/slo")
    rows = json.loads(body)["tenants"]
    tcode, tbody, tms = _http(port, "/tenants")
    trows = json.loads(tbody)["tenants"]
    for t in ("slo_tight", "slo_loose"):
        say("slo", tenant=t, requests=rows[t]["requests"], bad=rows[t]["bad"],
            target_us=rows[t]["target"]["gather_p99_us"],
            burn_fast=rows[t]["slo_burn_fast"],
            burn_slow=rows[t]["slo_burn_slow"],
            burning=rows[t]["slo_burning"],
            tenants_row_burning=trows[t].get("slo_burning"))
    say("slo", tenant_engine_op_p50_us=p50, slo_status=code,
        slo_ms=f"{ms:.2f}",
        tenants_status=tcode, tenants_ms=f"{tms:.2f}")
    if not (rows["slo_tight"]["slo_burning"]
            and trows["slo_tight"].get("slo_burning") is True
            and not rows["slo_loose"]["slo_burning"]
            and trows["slo_loose"].get("slo_burning") is False):
        raise AssertionError("slo: the tight tenant must burn on /slo and "
                             "/tenants, the loose one must not")


_FED_HOST = (
    "import sys\n"
    "from strom_torch.config import StromConfig\n"
    "from strom_torch.delivery.core import StromContext\n"
    "ctx = StromContext(StromConfig.from_env(), metrics_port=0)\n"
    "ctx.pread(sys.argv[1], 0, 64 << 20)\n"
    "print(ctx.metrics_server.port, flush=True)\n"
    "sys.stdin.read()\n")


def _federation_arm(ctx, path: str, flight_dir: str) -> None:
    """[federation]: a ClusterView over this context's endpoint and a
    subprocess context's (a registry of its own): the aggregate equals the
    hosts' sum; killing the subprocess flips it unhealthy within stale_s
    (plus the poll interval) and leaves a flight bundle."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = root
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", _FED_HOST, path],
                            cwd=root, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    try:
        sub = int(proc.stdout.readline())
        start_s = time.perf_counter() - t0
        me = ctx.metrics_server.port
        hosts = {"sub": f"127.0.0.1:{sub}", "me": f"127.0.0.1:{me}"}
        view = ctx.attach_cluster(hosts, interval_s=FED_INTERVAL_S,
                                  stale_s=FED_STALE_S, stall_s=600.0)
        deadline = time.monotonic() + 30.0
        while not all(r["age_s"] is not None for r in
                      view.snapshot()["hosts"].values()):
            if time.monotonic() > deadline:
                raise AssertionError("federation: a host was never scraped")
            time.sleep(0.05)
        snap = view.snapshot()
        fetched = {h: json.loads(_http(int(a.rsplit(":", 1)[1]),
                                       "/stats?sections=steps")[1])["global"]
                   for h, a in hosts.items()}
        agg = snap["aggregate"]
        sums = {k: sum(f.get(k, 0) for f in fetched.values())
                for k in FED_SUM_KEYS}
        say("federation", hosts=len(hosts), sub_start_s=f"{start_s:.2f}",
            **{f"agg_{k}": agg.get(k, 0) for k in FED_SUM_KEYS},
            **{f"{h}_ssd2gpu_bytes": f.get("ssd2gpu_bytes", 0)
               for h, f in fetched.items()},
            agg_engine_op_lat_p99_us=agg.get("engine_op_lat_p99_us"))
        if any(agg.get(k, 0) != sums[k] for k in FED_SUM_KEYS) \
                or sums["ssd2gpu_bytes"] <= 0:
            raise AssertionError(f"federation: aggregate {agg} is not the "
                                 f"sum {sums}")
        proc.kill()
        proc.wait(timeout=30)
        t_kill = time.monotonic()
        while view.snapshot()["hosts"]["sub"]["healthy"]:
            if time.monotonic() - t_kill > 30.0:
                raise AssertionError("federation: the killed host never "
                                     "turned unhealthy")
            time.sleep(0.02)
        flip_s = time.monotonic() - t_kill
        # the view's thread dumps the bundle after the flip, outside its
        # lock: a full ring takes about a second to write
        while True:
            bundles = sorted(b for b in os.listdir(flight_dir)
                             if b.startswith("flight-")
                             and "cluster_unhealthy" in b)
            if bundles or time.monotonic() - t_kill > 30.0:
                break
            time.sleep(0.05)
        bundle_s = time.monotonic() - t_kill
        code, body, _ = _http(me, "/cluster")
        say("federation", killed="sub", flip_s=f"{flip_s:.3f}",
            stale_s=FED_STALE_S, interval_s=FED_INTERVAL_S,
            cluster_status=code,
            hosts_unhealthy=json.loads(body)["cluster_hosts_unhealthy"],
            flight_bundles=len(bundles), bundle_s=f"{bundle_s:.3f}")
        if flip_s > FED_STALE_S + 2 * FED_INTERVAL_S or not bundles:
            raise AssertionError(f"federation: flipped after {flip_s:.3f} s "
                                 f"(stale_s {FED_STALE_S}), bundles "
                                 f"{bundles}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _bench_tune(workdir: str) -> None:
    """[tune]: strom_torch.cli.bench_tune at the reference's defaults (a 128
    MiB file in shuffled 128 KiB blocks, a 32 MiB cache, 16 trials, 3
    iterations): the hand knobs, the coordinate-descent search over the
    scheduler's slice and the cache budget, an interleaved A/B (a searched
    state that loses it ships the hand knobs). ``tuned_vs_hand`` is at
    least 1.0 by that construction, so its check only shows the arm ran;
    ``searched_vs_hand`` is the searched state's own rate over the hand
    knobs', which a search that hurts drives below 1."""
    t0 = time.perf_counter()
    # the reference's defaults: 128 MiB, a 32 MiB cache, 16 trials
    out = cli.bench_tune(cli.build_parser().parse_args(
        ["tune", "--json", "--tmpdir", workdir]))
    say("tune", arm="bench_tune", **{k: out[k] for k in (
        "bytes", "block", "engine", "trials", "hand_items_per_s",
        "tuned_items_per_s", "searched_items_per_s", "searched_vs_hand",
        "tuned_vs_hand", "tune_moves", "tune_reverts", "tune_holds")},
        tune_knobs=json.dumps(out["tune_knobs"], sort_keys=True),
        s=f"{time.perf_counter() - t0:.2f}", via="strom_torch.cli.bench_tune")
    os.unlink(os.path.join(workdir, "strom_bench_tune.bin"))
    if out["tuned_vs_hand"] < 1.0:
        raise AssertionError(f"tune: tuned_vs_hand {out['tuned_vs_hand']} "
                             f"< 1.0")


def _tune_beats(tar: str | None) -> None:
    """[tune] beats: attach_tuner(start=False) on a context feeding the
    JPEG ResNet loader into a captured ResNet-50 step; TUNE_BEATS beats,
    each at least TUNE_BEAT_S of steps (past the steps section's TTL, so
    each beat reads a fresh goodput): the beat's goodput, its action and
    the knob values."""
    from strom_torch.tune import prefetcher_knob, standard_knobs

    if tar is None:
        say("tune", arm="beats", skipped=NO_JPEG)
        return
    cuda = torch.device("cuda")
    cfg = ResNetConfig.resnet50()
    model = ResNet(cfg, device=cuda)
    step = make_resnet_sgd_step(cfg, device=cuda)
    ctx = StromContext(StromConfig.from_env(history_interval_s=0.5,
                                            hot_cache_bytes=256 * MiB,
                                            readahead_window_batches=2),
                       metrics_port=0)
    try:
        pipe = make_imagenet_resnet_pipeline(ctx, [tar], batch=128,
                                             device=cuda)
        knobs = standard_knobs(ctx) + [prefetcher_knob(pipe._prefetcher)]
        tuner = ctx.attach_tuner(knobs, start=False)
        steps = 0
        for beat in range(TUNE_BEATS):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < TUNE_BEAT_S:
                imgs, lbls = next(pipe)
                step(model, imgs, lbls)["loss"].item()
                steps += 1
            action = tuner.step()
            m = ctx._tune_metrics()
            say("tune", arm="beats", beat=beat, action=action, steps=steps,
                goodput_pct=m["objective"],
                ingest_wait_us_per_s=m.get("stall_ingest_wait_us_per_s"),
                knobs=json.dumps(tuner.stats()["tune_knobs"],
                                 sort_keys=True))
        st = ctx.stats(["tune"])["tune"]
        say("tune", arm="beats", **{k: st[k] for k in (
            "tune_moves", "tune_reverts", "tune_holds", "tune_trials",
            "tuned_vs_baseline")}, route_tune=_http(
                ctx.metrics_server.port, "/tune")[0])
        pipe.close()
    finally:
        ctx.close()
        del model, step
        torch.cuda.empty_cache()


def _inflight_arm(path: str) -> None:
    """[inflight]: the engine_inflight gauge read from another thread while
    a 256 MiB gather on the preadv pool runs (above 0), and after it
    (0)."""
    seen: list[float] = []
    done = threading.Event()

    def watch() -> None:
        while not done.is_set():
            seen.append(global_stats.gauge("engine_inflight").value)
            time.sleep(0.0005)

    # the preadv pool (the card's engine: io_uring is refused there) sets
    # the gauge at every submit and reap; io_uring's native gather sets it
    # once, after the gather
    ctx = StromContext(StromConfig.from_env(engine="python"))
    w = threading.Thread(target=watch)
    try:
        _drop_cache(path)
        w.start()
        ctx.pread(path, 0, 256 * MiB)
    finally:
        done.set()
        w.join()
        ctx.close()
    after = global_stats.gauge("engine_inflight").value
    say("inflight", reads=len(seen), max_mid_gather=max(seen, default=0),
        after=after)
    if max(seen, default=0) <= 0 or after != 0:
        raise AssertionError(f"inflight: max {max(seen, default=0)} "
                             f"mid-gather, {after} after")


def phase_observability(workdir: str, tar: str | None) -> None:
    """Phase 12: the live observability plane beside the main path, the
    SLO engine, federation across processes, the autotuner, and the
    engine_inflight gauge."""
    t0 = time.perf_counter()
    flight_dir = os.path.join(workdir, "flight12")
    path = os.path.join(workdir, "obs.bin")
    _write_file(path, np.frombuffer(bytearray(
        np.random.default_rng(13).bytes(256 * MiB)), np.uint8))
    ctx = StromContext(StromConfig.from_env(history_interval_s=0.5,
                                            flight_dir=flight_dir,
                                            flight_stall_s=0.0),
                       metrics_port=0)
    try:
        _server_arm(ctx, workdir)
        _slo_arm(ctx, path)
        _federation_arm(ctx, path, flight_dir)
        code, body, _ = _http(ctx.metrics_server.port, "/history?keys="
                              "ssd2gpu_bytes")
        hist = json.loads(body)
        say("history", status=code, samples=len(hist["samples"]),
            interval_s=hist["interval_s"],
            sample_errors=hist["sample_errors"],
            ssd2gpu_bytes_per_s=ctx.history.rate("ssd2gpu_bytes"))
    finally:
        ctx.close()
    _server_loader_arm(tar)
    _bench_tune(workdir)
    _tune_beats(tar)
    _inflight_arm(path)
    os.unlink(path)
    say("observability", s=f"{time.perf_counter() - t0:.2f}")


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


# ------------------------------------------------------------ numa (3b)
NUMA_ROUNDS = 4


def _gpu_numa_node() -> tuple[str, int | None]:
    """The card's PCI address and its NUMA node from sysfs (None: the
    kernel reports none, -1, or the file is missing)."""
    p = torch.cuda.get_device_properties(0)
    if not hasattr(p, "pci_domain_id"):
        return "unknown", None
    bus = (f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:"
           f"{p.pci_device_id:02x}.0")
    try:
        with open(f"/sys/bus/pci/devices/{bus}/numa_node") as f:
            node = int(f.read().strip())
    except (OSError, ValueError):
        node = None
    return bus, (node if node is not None and node >= 0 else None)


def phase_numa(path: str) -> int | None:
    """[numa]: the host's NUMA nodes and CPUs per node, the node of the disk
    holding *path* and of the card. On more than one node, phase 3's 1 GiB
    delivery with numa_affinity off and on, alternating for NUMA_ROUNDS
    rounds (the slabs bound to the disk's node, else the card's, before
    they are pinned): GB/s and host CPU s per GiB. irq_affinity stays off:
    it writes /proc/irq. Returns the disk's node (None: unknown)."""
    from strom_torch.probe.topology import device_for_file
    from strom_torch.utils.numa import node_cpus

    nodes = sorted(int(os.path.basename(p)[4:]) for p in
                   glob.glob("/sys/devices/system/node/node[0-9]*"))
    try:
        dev = device_for_file(path)
    except OSError:
        dev = None
    disk_node = dev.numa_node if dev is not None else None
    bus, gpu_node = _gpu_numa_node()
    say("numa", nodes=len(nodes), node_ids=",".join(map(str, nodes)),
        cpus_per_node=json.dumps({n: len(node_cpus(n)) for n in nodes}),
        disk=dev.name if dev is not None else "none(no_block_device)",
        disk_node=disk_node, gpu_bus=bus, gpu_node=gpu_node)
    if len(nodes) < 2:
        say("numa", uma=True, ab="none: one node, so no A/B can run"
            if nodes else "none: sysfs shows no NUMA node, so no A/B can "
            "run")
        return disk_node
    target = disk_node if disk_node is not None else gpu_node
    if target is None:
        say("numa", ab="none: neither the disk nor the card reports a node")
        return disk_node
    data = np.fromfile(path, dtype=np.uint8)
    want = torch.from_numpy(data).to("cuda")
    del data
    before = os.sched_getaffinity(0)
    res: dict[bool, list] = {False: [], True: []}
    try:
        for r in range(NUMA_ROUNDS):
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                ctx = StromContext(StromConfig.from_env(
                    engine="auto", numa_affinity=on, numa_node=target))
                try:
                    _drop_cache(path)
                    res[on].append(_timed_delivery(
                        f"numa-{'on' if on else 'off'}-r{r}",
                        lambda: ctx.memcpy_ssd2gpu(path, device="cuda"),
                        want))
                finally:
                    ctx.close()
    finally:
        os.sched_setaffinity(0, before)
    for on in (False, True):
        say("numa", arm="on" if on else "off", node=target,
            rounds=NUMA_ROUNDS,
            gbps_median=f"{statistics.median(g for g, _ in res[on]):.3f}",
            gbps=",".join(f"{g:.3f}" for g, _ in res[on]),
            cpu_s_per_gib_median=
            f"{statistics.median(c for _, c in res[on]):.4f}")
    del want
    torch.cuda.empty_cache()
    return disk_node


# -------------------------------------------------------------- cli (13)
# python -m strom_torch.cli, run as -m runs it (runpy, __main__), with the
# flash wrappers' launch counts printed on stderr at exit
_CLI_LAUNCHER = (
    "import atexit, json, runpy, sys\n"
    "from strom_torch.ops import flash_attention as fa\n"
    "atexit.register(lambda: print('launches ' + json.dumps(dict("
    "fa.VARIANT_LAUNCHES)), file=sys.stderr, flush=True))\n"
    "sys.argv = ['strom_torch.cli'] + sys.argv[1:]\n"
    "runpy.run_module('strom_torch.cli', run_name='__main__')\n")
CLI_TIMEOUT_S = 420


def _cli_run(args: list[str], timeout: float = CLI_TIMEOUT_S
             ) -> tuple[int, dict, dict, float, str]:
    """(rc, the last stdout line as JSON, the flash launches, seconds,
    stderr's tail) of one strom_torch.cli subprocess."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CLI_LAUNCHER, *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    dt = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
    try:
        out = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        out = {}
    launches = {}
    for ln in proc.stderr.splitlines():
        if ln.startswith("launches "):
            launches = json.loads(ln[len("launches "):])
    return proc.returncode, out, launches, dt, proc.stderr[-3000:]


def _cli_fail(cmd: str, rc: int, err: str, why: str) -> None:
    raise AssertionError(f"cli {cmd}: {why} (rc {rc}); stderr tail:\n{err}")


def _daemon_start(fdir: str):
    """``python -m strom_torch.cli daemon`` started, its ready line read on
    a thread; returns (process, the reader's result, its thread, t0)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "strom_torch.cli", "daemon", "--metrics-port",
         "0", "--flight-dir", fdir, "--flight-stall-s", "0",
         "--drain-timeout", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    got: dict = {}

    def read_ready() -> None:
        got["line"] = proc.stdout.readline()
        got["s"] = time.perf_counter() - t0

    th = threading.Thread(target=read_ready, name="cli-daemon-ready")
    th.start()
    return proc, got, th, t0, fdir


def _daemon_finish(proc, got: dict, th, t0: float, fdir: str) -> str:
    """The daemon's checks: the ready line, a tenant registered over POST
    /tenants, then SIGTERM: drained with stuck=[], ended by the signal, a
    flight bundle. Returns its output."""
    import signal
    import urllib.request

    try:
        th.join(timeout=120)
        ready = got.get("line", "")
        if "strom daemon ready" not in ready:
            raise AssertionError(f"cli daemon: no ready line: {ready!r}")
        port = int(ready.split("port=")[1].split()[0])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tenants",
            data=json.dumps({"op": "register", "name": "ext",
                             "priority": "interactive"}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            reg = json.load(r)
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    bundles = os.listdir(fdir) if os.path.isdir(fdir) else []
    say("cli", cmd="daemon", s=f"{time.perf_counter() - t0:.1f}",
        ready_s=f"{got['s']:.1f}", registered=reg.get("name"),
        drained="strom daemon drained" in text,
        stuck_none="stuck=[]" in text, rc=proc.returncode,
        sigterm_bundle=any("sigterm" in b for b in bundles))
    if reg.get("name") != "ext" or "stuck=[]" not in text \
            or proc.returncode != -signal.SIGTERM:
        raise AssertionError(f"cli daemon: register {reg}, rc "
                             f"{proc.returncode}, output {text[-2000:]}")
    return text


def _expected_hits() -> dict[str, int]:
    """The count of value > 0 in each parquet fixture ``all`` writes: its
    value column is the first draw of default_rng(0)."""
    h500 = int((np.random.default_rng(0).standard_normal(500_000) > 0).sum())
    h200 = int((np.random.default_rng(0).standard_normal(200_000) > 0).sum())
    return {"parquet": h500, "parquet_raid0": h500, "parquet_wide": h200,
            "parquet_plain": h200}


def phase_cli(workdir: str, disk_node: int | None) -> dict[str, int]:
    """Phase 13: the CLI as a user runs it, each subcommand a subprocess of
    ``python -m strom_torch.cli ... --json --tmpdir <workdir>`` (the files
    stay off /tmp): ``nvme`` (256 MiB, the disk's NUMA node where it has
    one), ``check`` of its file, ``all`` (rc 0, nothing failed, every byte
    count the size asked for, the Parquet counts exact, finite losses,
    Llama-small's data-stall steps, its flash step on the three wgmma
    kernels), ``checkpoint --model small`` (the round trip exact, no
    spill-epoch source miss), and ``daemon`` (started first and idle
    while the others run; then ready, a tenant registered over POST
    /tenants, drained on SIGTERM, ended by it). Returns the Llama-small
    flash launches of ``all``."""
    d = os.path.join(workdir, "cli")
    os.makedirs(d, exist_ok=True)
    common = ["--json", "--tmpdir", d]
    # the daemon starts first and idles (no stall trigger) while the other
    # subcommands run; it is driven at the end
    daemon = _daemon_start(os.path.join(d, "flight"))
    try:
        size = 256 * MiB
        numa = ["--numa-node", str(disk_node)] if disk_node is not None else []
        rc, out, _, dt, err = _cli_run(["nvme", "--size", str(size), "--iters",
                                        "1", *numa, *common])
        if rc or out.get("bytes") != size:
            _cli_fail("nvme", rc, err, f"bytes {out.get('bytes')} != {size}")
        say("cli", cmd="nvme", s=f"{dt:.1f}", rc=rc, bytes=out["bytes"],
            gbps=out["gbps"], engine=out["engine"], numa_node=out["numa_node"],
            media_bytes=out["media_bytes"], cached_bytes=out["cached_bytes"])
        path = os.path.join(d, "strom_bench_nvme.bin")
        rc, out, _, dt, err = _cli_run(["check", path, "--json"])
        if rc or out.get("size") != os.path.getsize(path):
            _cli_fail("check", rc, err, "no report of the file")
        say("cli", cmd="check", s=f"{dt:.1f}", rc=rc, size=out["size"],
            fs=out["fs"], tier=out["tier"], supported=out["supported"],
            extents=out["extents"], cached_frac=out["cached_frac"])

        rc, out, launches, dt, err = _cli_run(["all", *common])
        if rc or out.get("failed") != []:
            _cli_fail("all", rc, err, f"failed {out.get('failed')}")
        byte_ok = {k: out[k]["bytes"] == size for k in
                   ("nvme", "ssd2host", "ssd2host_raid", "ssd2gpu")}
        want_hits = _expected_hits()
        hits_ok = {k: out[k]["hits"] == v for k, v in want_hits.items()}
        losses = {k: out[k]["train_loss"] for k in
                  ("llama", "resnet", "resnet_predecoded", "vit")}
        small = check_variants(KERNELS, launches, "cli all llama small")
        for k, v in out.items():
            if isinstance(v, dict):
                say("cli", cmd="all", part=k, wall_s=v.get("wall_s"),
                    **{f: v[f] for f in (
                        "gbps", "bytes", "vs_raw", "tokens_per_s",
                        "train_tokens_per_s", "train_data_stalls",
                        "images_per_s", "train_images_per_s", "train_loss",
                        "rows_per_s", "selected_gbps", "hits", "vs_disk",
                        "devices") if f in v})
        say("cli", cmd="all", s=f"{dt:.1f}", rc=rc, failed=out["failed"],
            bytes_exact=all(byte_ok.values()), hits_exact=all(hits_ok.values()),
            hits=json.dumps({k: out[k]["hits"] for k in want_hits}),
            losses=json.dumps(losses),
            llama_small_data_stalls=out["llama"]["train_data_stalls"],
            llama_small_step_ms=f"{8 * 2048 / out['llama']['train_tokens_per_s'] * 1e3:.2f}",
            llama_small_bounded=out["llama"].get("bounded_train_data_stalls"),
            llama_small_launches=json.dumps(small, sort_keys=True))
        if not all(byte_ok.values()) or not all(hits_ok.values()) or not all(
                math.isfinite(x) for x in losses.values()):
            _cli_fail("all", rc, err, f"bytes {byte_ok}, hits {hits_ok} "
                      f"(want {want_hits}), losses {losses}")

        rc, out, _, dt, err = _cli_run(["checkpoint", "--model", "small",
                                        *common])
        if rc or out.get("ckpt_roundtrip_ok") != 1 \
                or out.get("spill_cache_miss_bytes") != 0:
            _cli_fail("checkpoint", rc, err, f"round trip "
                      f"{out.get('ckpt_roundtrip_ok')}, spill misses "
                      f"{out.get('spill_cache_miss_bytes')}")
        say("cli", cmd="checkpoint", model="small", s=f"{dt:.1f}", rc=rc,
            **{k: out[k] for k in ("ckpt_bytes", "ckpt_leaves",
                                   "ckpt_save_mb_per_s", "ckpt_restore_mb_per_s",
                                   "ckpt_pickle_save_mb_per_s",
                                   "ckpt_save_vs_pickle", "ckpt_roundtrip_ok", "spill_hit_bytes",
                                   "spill_cache_miss_bytes")})

    except BaseException:
        daemon[0].kill()   # a failed subcommand leaves no daemon
        daemon[0].communicate(timeout=30)
        daemon[2].join(timeout=30)
        raise
    _daemon_finish(*daemon)
    shutil.rmtree(d, ignore_errors=True)
    return small


# --------------------------------------------------------------- dp (12b)
DP_CONFIG = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
DP_ROWS, DP_SEQ = 2, 2047       # a card's rows of the batch, phase 4's
DP_COUNTED, DP_TIMED = 4, 4     # warm-up, capture, 2 replays; then timed
DP_TIMEOUT_S = 600
# the dp step's counted (loss, grad_norm) against make_train_step without a
# mesh on the global batch, relative. Two sound runs on H100s: world 1 equal
# bit for bit; world 4 (bf16 rows reduced in another order, gradients
# averaged in a bf16 bucket) at most 4.5e-6 and 2.4e-5. A step that skipped
# the division by the world (or summed a bucket twice) reports grad_norm x
# world: a relative error of 1 or more at world 2 and above.
DP_PLAIN_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}


def _card_line(index: int) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _param_checksum(model) -> torch.Tensor:
    """Each parameter's bits summed as integers (int64, in 64M-element
    pieces): replicas that hold the same bits give the same row."""
    out = []
    for p in model.parameters():
        bits = p.detach().reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[p.element_size()])
        out.append(sum(c.sum(dtype=torch.int64) for c in bits.split(1 << 26)))
    return torch.stack(out)


def _dp_profile(run, tail: int = 0) -> dict:
    """One more replay under torch.profiler (*run()* takes the step and
    returns its loss tensor): the device time of the NCCL kernels (the
    all-reduces), of every kernel, and the step's wall time. *tail*: how
    many of the NCCL kernels, the last by start, are the gradient buckets
    and the loss (``tail_ms``; the ones before them, ``head_ms``, are the
    forward and backward's own: ResNet's batch norm). ``nccl_ms`` splits
    the NCCL device ms by collective (``AllReduce``, ``SendRecv``,
    ``AllGather``, ...), read from the kernels' names."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        run().item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    nccl = sorted((a, b) for a, b, n in spans if "nccl" in n.lower())
    by_op: dict[str, float] = {}
    for a, b, n in spans:
        if "nccl" in n.lower():
            m = re.search(r"nccl(?:Dev)?Kernel_([A-Za-z]+)", n)
            op = m.group(1) if m else "other"
            by_op[op] = by_op.get(op, 0.0) + (b - a) / 1e3
    cut = max(len(nccl) - tail, 0)
    return {"wall_ms": wall_ms, "device_events": len(spans),
            "device_ms": sum(b - a for a, b, _ in spans) / 1e3,
            "allreduce_kernels": len(nccl),
            "allreduce_ms": sum(b - a for a, b in nccl) / 1e3,
            "head_kernels": cut,
            "head_ms": sum(b - a for a, b in nccl[:cut]) / 1e3,
            "tail_ms": sum(b - a for a, b in nccl[cut:]) / 1e3,
            "nccl_ms": by_op}


def _plain_steps(cfg, dev: torch.device, batches: list[torch.Tensor]
                 ) -> list[dict[str, float]]:
    """{loss, grad_norm} of each step of make_train_step without a mesh (one
    card, the whole global batch), from init_train_state(seed=0): the
    parameters every dp replica starts from. Its state is freed after."""
    state = init_train_state(cfg, device=dev, seed=0)
    step = make_train_step(cfg, attn="flash", device=dev)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append({k: m[k].item() for k in ("loss", "grad_norm")})
    del state, step
    torch.cuda.empty_cache()
    return out


def dp_worker(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of phase 12b, on card *rank*: its kernels against the plain
    versions, the sharded Llama loader into the data-parallel captured
    step (rank 0 holding its counted steps against the step without a
    mesh on the global batch), and the group-summed Parquet scans. Prints
    its [dp] lines and writes its numbers to dp_rank<rank>.json in
    *workdir*."""
    from strom_torch.parallel import mesh as pmesh
    from strom_torch.parallel.sharding import P, TorchSharding

    os.environ["LOCAL_RANK"] = str(rank)
    pmesh.init_distributed("cuda", rank=rank, world_size=world,
                           init_method=f"tcp://localhost:{port}")
    dev = torch.device("cuda", rank)
    card = _card_line(rank)
    tag = {"world": world, "rank": rank, "device": f"cuda:{rank}",
           "card": card.replace(" ", "_")}
    n = torch.cuda.device_count()
    if rank == 0 and world == n:   # once, at the machine's full world
        got = subprocess.run(["nvidia-smi", "topo", "-m"],
                             capture_output=True, text=True)
        for line in (got.stdout + got.stderr).rstrip().splitlines():
            print(f"[topo] topo -m: {line}", flush=True)
        # nvlink --status: a "GPU i: ..." line, then "Link j: <rate> GB/s"
        got = subprocess.run(["nvidia-smi", "nvlink", "--status"],
                             capture_output=True, text=True)
        links: dict[str, list[float]] = {}
        for line in got.stdout.splitlines():
            if line.startswith("GPU "):
                gpu = line.split(":")[0][4:]
                links[gpu] = []
            elif "Link" in line and "GB/s" in line and links:
                links[gpu].append(float(line.split(":")[1].split()[0]))
        for gpu, rates in links.items():
            say("topo", gpu=gpu, nvlinks=len(rates),
                gbps_each=",".join(sorted({f"{r:g}" for r in rates})),
                gbps_total=f"{sum(rates):.3f}")
        say("topo", world=world, cards=n, nccl=".".join(
            map(str, torch.cuda.nccl.version())), torch=torch.__version__,
            cuda=torch.version.cuda, peer_access=";".join(
                "".join("x" if i == j else str(int(
                    torch.cuda.can_device_access_peer(i, j)))
                        for j in range(n)) for i in range(n)))
    # the three kernels against their plain versions on this card, at the
    # main path's shape
    q, k, v, g = _inputs(2, 2048, 32, 8, 128, torch.bfloat16, rank)
    res, lse, delta = _run_kernels(q, k, v, g, True)
    errs = _check_against_plain(f"dp rank {rank}", res, q, k, v, g, lse,
                                delta, True, 128, BF16_TOL)
    say("dp", **tag, check="kernels vs plain (BF16_TOL), B 2 S 2048 H 32 "
        "KV 8 Dh 128 bf16 causal",
        **{f"{n}_max_abs_err": f"{e:.4g}" for n, e in errs.items()})
    del q, k, v, g, res, lse, delta
    # the sharded loader into the data-parallel step
    cfg = DP_CONFIG
    B = DP_ROWS * world
    records = 3 * world           # a shard: epochs of 3 global batches
    shards = [np.fromfile(os.path.join(workdir, f"dp_tokens{i}.bin"),
                          dtype=np.int32).reshape(records, DP_SEQ + 1)
              for i in range(2)]
    all_records = torch.from_numpy(np.concatenate(shards)).to(dev)
    paths = [os.path.join(workdir, f"dp_tokens{i}.bin") for i in range(2)]
    mesh = pmesh.make_mesh({"dp": world})
    sharding = TorchSharding(mesh, P("dp", None))
    ctx = StromContext(StromConfig.from_env())
    eng0 = ctx.engine.stats()["bytes_read"]
    xfer0 = ctx.stats()["context"]["transfers"]
    pipe = make_llama_pipeline(ctx, paths, batch=B, seq_len=DP_SEQ,
                               sharding=sharding, epoch_sync=True, seed=0)
    sampler = iter(EpochShuffleSampler(2 * records, B, seed=0))
    orders = [torch.from_numpy(next(sampler)).to(dev)
              for _ in range(DP_COUNTED + DP_TIMED)]
    # before the replicas exist, so that one card holds one model at a time
    plain = _plain_steps(cfg, dev, [all_records[o] for o in
                                    orders[:DP_COUNTED]]) if rank == 0 else []
    state = init_train_state(cfg, device=dev, seed=0, mesh=mesh)
    step = make_train_step(cfg, attn="flash", device=dev, mesh=mesh)
    rows = slice(rank * DP_ROWS, (rank + 1) * DP_ROWS)
    fa.reset_launch_counts()
    times, calls, losses, variants, stalls0 = [], [], [], {}, 0
    sums = torch.empty(world, len(list(state.model.parameters())),
                       dtype=torch.int64, device=dev)
    for i in range(DP_COUNTED + DP_TIMED):
        batch = next(pipe)
        want = all_records[orders[i]]
        local = batch.to_local()
        if tuple(batch.shape) != (B, DP_SEQ + 1) or local.device != dev \
                or not torch.equal(local, want[rows]) \
                or not torch.equal(batch.full_tensor(), want):
            raise AssertionError(f"dp rank {rank} step {i}: the batch "
                                 "differs from the file's rows in sampler "
                                 "order")
        if i == DP_COUNTED:
            stalls0 = pipe.data_stall_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        calls.append(step.last_call)
        losses.append(loss)
        got = {"loss": loss, "grad_norm": metrics["grad_norm"].item()}
        rel = {f"{k}_rel_to_plain": abs(got[k] - plain[i][k]) / abs(plain[i][k])
               for k in got} if i < len(plain) else {}
        torch.distributed.all_gather_into_tensor(
            sums, _param_checksum(state.model))
        equal = bool((sums == sums[0]).all())
        say("dp", **tag, step=i, call=step.last_call, loss=f"{loss:.5f}",
            grad_norm=f"{got['grad_norm']:.5f}", ms=f"{times[-1] * 1e3:.2f}",
            param_checksum=int(sums[rank].sum()), replicas_equal=equal,
            **({"plain_loss": f"{plain[i]['loss']:.5f}",
                "plain_grad_norm": f"{plain[i]['grad_norm']:.5f}",
                **{k: f"{v:.3g}" for k, v in rel.items()}} if rel else {}))
        if not (equal and math.isfinite(loss)):
            raise AssertionError(f"dp rank {rank} step {i}: loss {loss}, "
                                 f"replica checksums {sums.tolist()}")
        if rel and any(rel[f"{k}_rel_to_plain"] > tol
                       for k, tol in DP_PLAIN_RTOL.items()):
            raise AssertionError(f"dp rank {rank} step {i}: {got} against "
                                 f"the step without a mesh {plain[i]} "
                                 f"(relative tolerance {DP_PLAIN_RTOL})")
        if i == DP_COUNTED - 1:
            variants = dict(fa.VARIANT_LAUNCHES)
    check_variants(KERNELS, variants, f"dp steps of rank {rank}")
    stalls = pipe.data_stall_steps - stalls0
    steady = times[DP_COUNTED:]
    report = pipe.straggler_report()
    batch = next(pipe)
    prof = _dp_profile(lambda: step(state, batch)[1]["loss"])
    pipe.close()
    nbytes = ctx.engine.stats()["bytes_read"] - eng0
    xfers = ctx.stats()["context"]["transfers"] - xfer0
    own = DP_ROWS * (DP_SEQ + 1) * 4
    say("dp", **tag, **_step_summary(step, times, calls, steady),
        timed_data_stalls=stalls, engine_bytes_read=nbytes,
        deliveries=xfers, rows_bytes=own,
        only_own_rows=nbytes == xfers * own,
        allreduce_ms=f"{prof['allreduce_ms']:.3f}",
        allreduce_kernels=prof["allreduce_kernels"],
        allreduce_share=f"{prof['allreduce_ms'] / prof['wall_ms']:.4f}",
        profiled_step_ms=f"{prof['wall_ms']:.2f}",
        device_busy_ms=f"{prof['device_ms']:.2f}",
        launches=json.dumps(variants, sort_keys=True))
    if rank == 0:
        say("dp", world=world, straggler_report=str(report).replace(" ", "_"),
            stragglers=list(report.stragglers))
    if nbytes != xfers * own or stalls:
        raise AssertionError(f"dp rank {rank}: read {nbytes} bytes in "
                             f"{xfers} deliveries of {own} (own rows only), "
                             f"{stalls} timed data stalls")
    del state, step, all_records
    torch.cuda.empty_cache()
    # the wide scan of phase 9's shards over the group, both reductions
    with open(os.path.join(workdir, "dp_pq.json")) as f:
        pq = json.load(f)
    fsum_tol = 27 * 2.0 ** -24 * pq["fabs"]   # phase 9's bound
    scans = {}
    for reduce in ("collective", "allgather"):
        units0 = global_stats.counter("parquet_scan_units").value
        t0 = time.perf_counter()
        out = parquet_scan_aggregate(
            ctx, pq["paths"], PQ_WIDE, lambda c: {
                "hits": (c["value"] > 0).sum(),
                "fsum": torch.stack([c[n].sum() for n in PQ_FEATURES]).sum()},
            reduce=reduce)
        dt = time.perf_counter() - t0
        hits, fsum = int(out["hits"]), float(out["fsum"])
        scans[reduce] = {"hits": hits, "fsum": fsum, "s": dt}
        say("dp", **tag, scan="wide", reduce=reduce, hits=hits,
            fsum=f"{fsum:.3f}", units=global_stats.counter(
                "parquet_scan_units").value - units0, s=f"{dt:.3f}",
            rows_per_s=f"{PQ_SHARDS * PQ_ROWS / dt:.1f}")
        if hits != pq["hits"] or abs(fsum - pq["fsum"]) > fsum_tol:
            raise AssertionError(f"dp rank {rank} scan {reduce}: hits {hits}"
                                 f" fsum {fsum} against {pq['hits']}, "
                                 f"{pq['fsum']} (tolerance {fsum_tol:.3f})")
    ctx.close()
    with open(os.path.join(workdir, f"dp_rank{rank}.json"), "w") as f:
        json.dump({"step_ms": [t * 1e3 for t in steady], "losses": losses,
                   "stalls": stalls, "bytes": nbytes, "deliveries": xfers,
                   "variants": variants, "allreduce_ms": prof["allreduce_ms"],
                   "allreduce_share": prof["allreduce_ms"] / prof["wall_ms"],
                   "scans": scans, "card": card}, f)
    pmesh.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_run(world: int, workdir: str) -> list[dict]:
    """Seeded token shards for *world* cards (3 global batches an epoch),
    then one worker process a card (``_spawn_ranks``). Returns their
    numbers."""
    rng = np.random.default_rng(14)
    for i in range(2):
        rng.integers(0, DP_CONFIG.vocab, (3 * world, DP_SEQ + 1),
                     dtype=np.int32).tofile(
            os.path.join(workdir, f"dp_tokens{i}.bin"))
    return _spawn_ranks("--dp-worker", "dp", world, workdir)


def _spawn_ranks(flag: str, name: str, world: int, workdir: str,
                 timeout_s: float = DP_TIMEOUT_S) -> list[dict]:
    """One worker process a card (this script with *flag*); every worker
    must exit 0 within *timeout_s*. Returns the numbers each wrote to
    <name>_rank<r>.json in *workdir*."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, here, flag, str(r), str(world), str(port),
         workdir], env=env, cwd=os.path.dirname(here)) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise AssertionError(f"{name} world {world}: worker exit codes {rcs}")
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{name}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _dp_cli(world: int, workdir: str) -> None:
    """The launched CLI on *world* cards, as the README gives it:
    ``python -m torch.distributed.run --standalone --nproc-per-node
    <world> -m strom_torch.cli llama --train-step --model small --attn
    flash`` (through _CLI_LAUNCHER, which adds each rank's flash launches
    to its stderr), 8 rows a card. Rank 0 alone prints the JSON: devices
    the world, a finite loss; every rank must have launched the three
    sm90 kernels."""
    launcher = os.path.join(workdir, "cli_launcher.py")
    with open(launcher, "w") as f:
        f.write(_CLI_LAUNCHER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(workdir, "dp_cli")
    os.makedirs(d, exist_ok=True)
    batch = 8 * world
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), launcher, "llama", "--train-step",
         "--model", "small", "--attn", "flash", "--batch", str(batch),
         "--steps", "10", "--json", "--tmpdir", d],
        capture_output=True, text=True, env=env, timeout=CLI_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    dt = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    ranks = [json.loads(ln[len("launches "):]) for ln in
             proc.stderr.splitlines() if ln.startswith("launches ")]
    cmd = f"torch.distributed.run --nproc-per-node {world} llama"
    if proc.returncode or len(lines) != 1 or len(ranks) != world:
        _cli_fail(cmd, proc.returncode, proc.stderr[-3000:],
                  f"{len(lines)} JSON lines, {len(ranks)} ranks' launches")
    out = json.loads(lines[0])
    for r, launches in enumerate(ranks):
        check_variants(KERNELS, launches, f"{cmd}, a rank ({r} of {world})")
    if out["devices"] != world or not math.isfinite(out["train_loss"]):
        _cli_fail(cmd, 0, proc.stderr[-3000:], f"devices {out['devices']}, "
                  f"loss {out['train_loss']}")
    say("dp", cli=cmd.replace(" ", "_"), s=f"{dt:.1f}", batch=batch,
        devices=out["devices"], train_loss=out["train_loss"],
        train_tokens_per_s=out["train_tokens_per_s"],
        train_step_ms=f"{batch * 2048 / out['train_tokens_per_s'] * 1e3:.2f}",
        train_data_stalls=out["train_data_stalls"],
        tokens_per_s=out["tokens_per_s"], card=_card_line(0).replace(" ", "_"))


def phase_dp(workdir: str, pq: tuple[list[str], dict] | None = None
             ) -> dict[str, list[int]]:
    """Phase 12b: the data-parallel path over every card (world 1 on a
    machine with one; world 1 and then world N on one with N). Per world,
    one worker a card (``dp_worker``), the parent having built the
    kernels; then per world the step ms of each rank, the losses (the
    group's mean: equal on every rank), and the weak-scaling ratio of
    world N's median step over world 1's, beside each card's name and
    power limit. Last, the launched CLI's llama arm on every card
    (``_dp_cli``). *pq*: phase 9's shards and numpy's answers (made here
    when phase 9 did not run). Returns each rank's launches over the last
    world's counted steps, by row of KERNELS."""
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()   # card 0's worker shares it with this process
    paths, ref = pq if pq is not None else _pq_fixture(workdir)
    with open(os.path.join(workdir, "dp_pq.json"), "w") as f:
        json.dump({"paths": paths, **ref}, f)
    medians: dict[int, float] = {}
    for world in ([1] if n == 1 else [1, n]):
        ranks = _dp_run(world, workdir)
        medians[world] = statistics.median(
            statistics.median(r["step_ms"]) for r in ranks)
        losses = {tuple(r["losses"]) for r in ranks}
        say("dp", world=world, cards=",".join(
            r["card"].replace(" ", "_") for r in ranks),
            step_ms_median=",".join(f"{statistics.median(r['step_ms']):.2f}"
                                    for r in ranks),
            allreduce_ms=",".join(f"{r['allreduce_ms']:.3f}" for r in ranks),
            allreduce_share=",".join(f"{r['allreduce_share']:.4f}"
                                     for r in ranks),
            timed_data_stalls=",".join(str(r["stalls"]) for r in ranks),
            losses_equal=len(losses) == 1,
            scan_hits=",".join(str(r["scans"][m]["hits"]) for r in ranks
                               for m in ("collective", "allgather")),
            tokens_per_s=f"{world * DP_ROWS * (DP_SEQ + 1) / medians[world] * 1e3:.0f}")
        if len(losses) != 1:
            raise AssertionError(f"dp world {world}: the ranks report "
                                 f"different losses {losses}")
    say("dp", worlds=",".join(map(str, medians)),
        weak_scaling=f"{medians[max(medians)] / medians[1]:.4f}",
        note="median step ms at the largest world over world 1's, the same "
             "rows a card", card=_card_line(0).replace(" ", "_"))
    _dp_cli(n, workdir)
    return {name: [r["variants"].get(info["variant"], 0) for r in ranks]
            for name, info in KERNELS.items()}


# ---------------------------------------------------------- dp_vision (12c)
DPV_ROWS, DPV_VIT_ROWS = 128, 64   # a card's rows: phases 6 and 8's batches
DPV_COUNTED, DPV_TIMED = 4, 4      # warm-up, capture, 2 replays; then timed
DPV_JPEG_STEPS = 4
DPV_RECORDS, DPV_JPEGS = 2048, 512
DPV_DEVICE = "cuda"   # the workers' device ("cpu" rehearses them at a tiny size)
# ResNet-50's gradient buckets (bf16, f32) and the loss: the last three
# NCCL kernels of a dp step; the 106 before them are its 53 batch norms'
# forward and backward all-reduces
DPV_TAIL = 3
# rank 0's counted dp ResNet-50 steps against make_resnet_sgd_step without
# a mesh on the whole global batch, each step from the replica's state:
# loss and grad_norm relative, and "bn", the largest norm-relative gap of
# a running batch-norm statistic after the step. Two sound runs on H100s
# (the same numbers in both): world 1 at most 9.4e-4, 7.6e-3 and 3.1e-3
# (the global batch norm's kernels against the fused one's, in bf16),
# world 4 at most 6.0e-4, 5.0e-3 and 1.5e-3; about twice the worst seen.
# A step with rank-local statistics at world 4 (128 rows a card) is off by
# 1.0e-3, 1.0e-2 and 1.4e-2: its running statistics fail the check, its
# loss and grad norm do not.
DPV_PLAIN_RTOL = {"loss": 2e-3, "grad_norm": 1.5e-2, "bn": 6e-3}
DPV_TIMEOUT_S = 300   # a world's workers


def _checksums(tensors, world: int) -> torch.Tensor:
    """Every rank's row of each tensor's bits summed as integers
    (all-gathered): replicas that hold the same bits give equal rows."""
    mine = torch.stack([
        sum(c.sum(dtype=torch.int64) for c in t.detach().reshape(-1).view(
            {2: torch.int16, 4: torch.int32}[t.element_size()]).split(1 << 26))
        for t in tensors])
    out = [torch.empty_like(mine) for _ in range(world)]
    torch.distributed.all_gather(out, mine)
    return torch.stack(out)


class _PlainVisionStep:
    """make_resnet_sgd_step without a mesh on one card and the whole global
    batch, each step taken from the parameters and batch-norm statistics
    of a dp replica (copied in place): the dp step's counterpart from the
    same parameters. A bf16 update of 1e-3·g mostly rounds to a last-bit
    change, so two runs that differ in the last bit of a gradient diverge
    within a step or two: starting each step from the replica's state
    compares one step at a time."""

    def __init__(self, cfg, dev: torch.device):
        self.model = ResNet(cfg, device=dev)
        self.step = make_resnet_sgd_step(cfg, device=dev)

    def __call__(self, replica, imgs: torch.Tensor, lbls: torch.Tensor
                 ) -> dict[str, float]:
        self.model.load_state_dict(replica.state_dict())
        m = self.step(self.model, imgs, lbls)
        return {k: m[k].item() for k in ("loss", "grad_norm")}

    def stats(self) -> dict[str, torch.Tensor]:
        """The running batch-norm statistics after the last step."""
        return dict(self.model.named_buffers())


def _local_bn_step(cfg, dev: torch.device, mesh, imgs: torch.Tensor,
                   lbls: torch.Tensor) -> tuple[dict[str, float], dict]:
    """One eager dp step from the same seed-0 parameters whose batch norm
    takes this rank's rows alone (the gradient and loss means as the dp
    step takes them): what the dp step would give with rank-local
    statistics. Returns its metrics and its running statistics."""
    from strom_torch.models.resnet import (imagenet_mean_std, loss_fn,
                                           normalize_images)
    from strom_torch.parallel import train as ptrain

    model = ResNet(cfg, device=dev)
    ptrain.replicate(model, mesh)
    loss, state = loss_fn(model, normalize_images(imgs,
                                                  imagenet_mean_std(dev)),
                          lbls.long() % cfg.num_classes)
    loss.backward()
    m = ptrain._dp_sgd(list(model.parameters()), loss,
                       ptrain._vision_dp(mesh), 1e-3)
    out = {k: m[k].item() for k in ("loss", "grad_norm")}
    state = {k: v.detach().clone() for k, v in state.items()}
    del model, m, loss
    torch.cuda.empty_cache()
    return out, state


def _rel(got: dict, want: dict) -> dict[str, float]:
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}


def _bn_gap(got: dict, want: dict) -> float:
    """The largest ‖got − want‖ / ‖want‖ over running batch-norm
    statistics (``*.mean``, ``*.var``) keyed by name."""
    return max(float((got[k].float() - want[k].float()).norm()
                     / want[k].float().norm()) for k in want
               if k.endswith((".mean", ".var")))


def dp_vision_worker(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of phase 12c, on card *rank*: ResNet-50 fed by the sharded
    predecoded pipeline into the data-parallel step (batch norm over the
    global batch; rank 0 holding its counted steps against the step
    without a mesh on the global batch, and the step with rank-local
    statistics beside it), the JPEG-fed ResNet arm, and ViT-B/16. Prints
    its [dp_vision] lines and writes its numbers to
    dp_vision_rank<rank>.json in *workdir*."""
    from strom_torch.parallel import mesh as pmesh
    from strom_torch.parallel.sharding import P, TorchSharding
    from strom_torch.parallel.train import replicate

    os.environ["LOCAL_RANK"] = str(rank)
    pmesh.init_distributed(DPV_DEVICE, rank=rank, world_size=world,
                           init_method=f"tcp://localhost:{port}")
    dev = pmesh.group_device()
    card = _card_line(rank)
    tag = {"world": world, "rank": rank, "device": str(dev),
           "card": card.replace(" ", "_")}
    with open(os.path.join(workdir, "dp_vision.json")) as f:
        paths = json.load(f)
    pdec, tar = paths["pdec"], paths["tar"]
    mesh = pmesh.make_mesh({"dp": world})
    sharding = TorchSharding(mesh, P("dp", None, None, None))
    B = DPV_ROWS * world
    rows = slice(rank * DPV_ROWS, (rank + 1) * DPV_ROWS)
    records = np.fromfile(pdec, dtype=np.uint8).reshape(-1, IMAGE, IMAGE, 3)
    all_records = torch.from_numpy(records).to(dev)
    all_labels = torch.from_numpy(np.load(pdec + LABELS_SUFFIX)).to(dev)
    sampler = iter(EpochShuffleSampler(len(records), B, seed=0))
    orders = [torch.from_numpy(next(sampler)).to(dev)
              for _ in range(DPV_COUNTED + DPV_TIMED)]
    del records
    cfg = ResNetConfig.resnet50()
    model = ResNet(cfg, device=dev)
    replicate(model, mesh)
    step = make_resnet_sgd_step(cfg, device=dev, mesh=mesh)
    plain = _PlainVisionStep(cfg, dev) if rank == 0 else None
    first = (all_records[orders[0]], all_labels[orders[0]])
    local_bn, local_stats = _local_bn_step(cfg, dev, mesh, first[0][rows],
                                           first[1][rows])
    gap = {}
    if plain is not None:
        want = plain(model, *first)
        gap = _rel(local_bn, want) | {"bn": _bn_gap(local_stats,
                                                    plain.stats())}
        say("dp_vision", **tag, check="step 0 with rank-local batch-norm "
            "statistics against the plain global step",
            loss=f"{local_bn['loss']:.6f}",
            grad_norm=f"{local_bn['grad_norm']:.6f}",
            plain_loss=f"{want['loss']:.6f}",
            plain_grad_norm=f"{want['grad_norm']:.6f}",
            **{f"{k}_rel_to_plain": f"{v:.3g}" for k, v in gap.items()},
            would_fail=any(gap[k] > DPV_PLAIN_RTOL[k] for k in gap))
        # past one card the check must tell rank-local statistics apart
        if world > 1 and not any(gap[k] > DPV_PLAIN_RTOL[k] for k in gap):
            raise AssertionError(f"dp_vision rank {rank}: a step with "
                                 f"rank-local statistics, {gap}, passes the "
                                 f"check against the plain step "
                                 f"({DPV_PLAIN_RTOL})")
    del first, local_stats
    ctx = StromContext(StromConfig.from_env())
    eng0 = ctx.engine.stats()["bytes_read"]
    xfer0 = ctx.stats()["context"]["transfers"]
    pipe = make_predecoded_vision_pipeline(ctx, [pdec], batch=B,
                                           image_size=IMAGE,
                                           sharding=sharding, seed=0)
    times, calls, losses, stalls0, worst = [], [], [], 0, {}
    for i in range(DPV_COUNTED + DPV_TIMED):
        imgs, lbls = next(pipe)
        order = orders[i]
        if tuple(imgs.shape) != (B, IMAGE, IMAGE, 3) \
                or tuple(lbls.shape) != (B,) \
                or not torch.equal(imgs.to_local(), all_records[order][rows]) \
                or not torch.equal(lbls.to_local(), all_labels[order][rows]):
            raise AssertionError(f"dp_vision rank {rank} step {i}: the batch "
                                 "differs from the file's rows in sampler "
                                 "order")
        if i == DPV_COUNTED:
            stalls0 = pipe.data_stall_steps
            if plain is not None:   # the timed steps run without it
                del plain
                plain = None
                torch.cuda.empty_cache()
        want = plain(model, all_records[order], all_labels[order]) \
            if plain is not None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, imgs, lbls)
        got = {k: m[k].item() for k in ("loss", "grad_norm")}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        calls.append(step.last_call)
        losses.append(got["loss"])
        rel = _rel(got, want) | {"bn": _bn_gap(dict(model.named_buffers()),
                                               plain.stats())} \
            if want is not None else {}
        sums = _checksums(list(model.parameters()), world)
        bn = _checksums(list(model.buffers()), world)
        equal = bool((sums == sums[0]).all())
        bn_equal = bool((bn == bn[0]).all())
        say("dp_vision", **tag, model="resnet50", step=i,
            call=step.last_call, loss=f"{got['loss']:.5f}",
            grad_norm=f"{got['grad_norm']:.5f}", ms=f"{times[-1] * 1e3:.2f}",
            replicas_equal=equal, bn_stats_equal=bn_equal,
            **({"plain_loss": f"{want['loss']:.5f}",
                "plain_grad_norm": f"{want['grad_norm']:.5f}",
                **{f"{k}_rel_to_plain": f"{v:.3g}" for k, v in rel.items()}}
               if rel else {}))
        if not (equal and bn_equal and math.isfinite(got["loss"])):
            raise AssertionError(f"dp_vision rank {rank} step {i}: {got}, "
                                 f"replica checksums {sums.tolist()}, "
                                 f"batch-norm {bn.tolist()}")
        for k, v in rel.items():
            worst[k] = max(worst.get(k, 0.0), v)
        if any(rel.get(k, 0.0) > tol for k, tol in DPV_PLAIN_RTOL.items()):
            raise AssertionError(f"dp_vision rank {rank} step {i}: {got} "
                                 f"against the step without a mesh "
                                 f"{want} (relative tolerance "
                                 f"{DPV_PLAIN_RTOL})")
    stalls = pipe.data_stall_steps - stalls0
    steady = times[DPV_COUNTED:]
    imgs, lbls = next(pipe)
    prof = _dp_profile(lambda: step(model, imgs, lbls)["loss"], DPV_TAIL)
    pipe.close()
    nbytes = ctx.engine.stats()["bytes_read"] - eng0
    xfers = ctx.stats()["context"]["transfers"] - xfer0
    own = DPV_ROWS * RECORD
    med = statistics.median(steady)
    say("dp_vision", **tag, model="resnet50",
        **_step_summary(step, times, calls, steady),
        images_per_s=f"{DPV_ROWS / med:.1f}", timed_data_stalls=stalls,
        engine_bytes_read=nbytes, deliveries=xfers, rows_bytes=own,
        only_own_rows=nbytes == xfers * own,
        nccl_kernels=prof["allreduce_kernels"],
        bn_allreduce_kernels=prof["head_kernels"],
        bn_allreduce_ms=f"{prof['head_ms']:.3f}",
        grad_allreduce_ms=f"{prof['tail_ms']:.3f}",
        allreduce_share=f"{prof['allreduce_ms'] / prof['wall_ms']:.4f}",
        profiled_step_ms=f"{prof['wall_ms']:.2f}",
        device_busy_ms=f"{prof['device_ms']:.2f}")
    if nbytes != xfers * own or stalls:
        raise AssertionError(f"dp_vision rank {rank}: read {nbytes} bytes in "
                             f"{xfers} deliveries of {own} (own rows only), "
                             f"{stalls} timed data stalls")
    out = {"resnet_ms": [t * 1e3 for t in steady], "losses": losses,
           "stalls": stalls, "bytes": nbytes, "deliveries": xfers,
           "bn_allreduce_ms": prof["head_ms"],
           "grad_allreduce_ms": prof["tail_ms"],
           "allreduce_share": prof["allreduce_ms"] / prof["wall_ms"],
           "plain_gap": worst, "local_gap": gap, "card": card}
    del all_records, all_labels, orders
    torch.cuda.empty_cache()

    # the JPEG-fed arm: this rank decodes its own rows of each batch
    dec0 = ctx.stats(sections=["decode"])["decode"]
    pipe = make_imagenet_resnet_pipeline(ctx, [tar], batch=B,
                                         image_size=IMAGE, sharding=sharding)
    jtimes, first = [], None
    for i in range(DPV_JPEG_STEPS):
        t0 = time.perf_counter()
        imgs, lbls = next(pipe)
        m = step(model, imgs, lbls)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        jtimes.append(time.perf_counter() - t0)
        if first is None:
            first = (imgs.to_local().clone(), lbls.to_local().clone())
        if not math.isfinite(loss):
            raise AssertionError(f"dp_vision rank {rank} JPEG step {i}: "
                                 f"loss {loss}")
    pipe.close()   # waits for the batches in flight: their counts too
    jstats = pipe.stats()
    dec1 = ctx.stats(sections=["decode"])["decode"]
    built = dec1["decode_batch_count"] - dec0["decode_batch_count"]
    decoded = sum(jstats.get(k, 0) for k in ("native_imgs", "cv2_imgs",
                                             "pil_imgs", "frames_from_cache"))
    slot = dec1["decode_slot_bytes"] - dec0["decode_slot_bytes"]
    # the same global batch from one process decoding all of it: this
    # rank's rows must be those, bit for bit (Philox keys by global row)
    with make_imagenet_resnet_pipeline(ctx, [tar], batch=B, device=dev,
                                       image_size=IMAGE,
                                       prefetch_depth=1) as whole:
        wimgs, wlbls = next(whole)
    same = torch.equal(first[0], wimgs[rows]) \
        and torch.equal(first[1], wlbls[rows])
    del wimgs, wlbls, first
    jmed = statistics.median(jtimes[1:])
    say("dp_vision", **tag, model="resnet50", arm="jpeg",
        steps=DPV_JPEG_STEPS, step_ms_median=f"{jmed * 1e3:.2f}",
        images_per_s=f"{DPV_ROWS / jmed:.1f}",
        data_stall_steps=jstats["data_stall_steps"], batches_built=built,
        rows_decoded=decoded, decode_slot_bytes=slot,
        only_own_rows=decoded == built * DPV_ROWS
        and slot == built * DPV_ROWS * RECORD,
        rows_equal_world1=same, stream_samples_early=jstats.get(
            "stream_samples_early", 0))
    if decoded != built * DPV_ROWS or slot != built * DPV_ROWS * RECORD \
            or not same:
        raise AssertionError(f"dp_vision rank {rank} JPEG arm: {built} "
                             f"batches, {decoded} rows decoded, {slot} slot "
                             f"bytes (own rows {DPV_ROWS} a batch); rows "
                             f"equal to one process's batch: {same}")
    out["jpeg_images_per_s"] = DPV_ROWS / jmed
    del model, step
    torch.cuda.empty_cache()

    # ViT-B/16, 64 rows a card, from the same shard
    vcfg = ViTConfig.vit_b16()
    vit = ViT(vcfg, device=dev,
              generator=torch.Generator(device=dev).manual_seed(0))
    replicate(vit, mesh)
    vstep = make_vit_sgd_step(vcfg, device=dev, mesh=mesh)
    pipe = make_predecoded_vision_pipeline(
        ctx, [pdec], batch=DPV_VIT_ROWS * world, image_size=IMAGE,
        sharding=sharding, seed=0)
    vtimes, vcalls, vstalls0 = [], [], 0
    for i in range(DPV_COUNTED + DPV_TIMED):
        imgs, lbls = next(pipe)
        if i == DPV_COUNTED:
            vstalls0 = pipe.data_stall_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = vstep(vit, imgs, lbls)["loss"].item()
        torch.cuda.synchronize()
        vtimes.append(time.perf_counter() - t0)
        vcalls.append(vstep.last_call)
        sums = _checksums(list(vit.parameters()), world)
        equal = bool((sums == sums[0]).all())
        if not (equal and math.isfinite(loss)):
            raise AssertionError(f"dp_vision rank {rank} ViT step {i}: loss "
                                 f"{loss}, replica checksums "
                                 f"{sums.tolist()}")
    vstalls = pipe.data_stall_steps - vstalls0
    pipe.close()
    vsteady = vtimes[DPV_COUNTED:]
    say("dp_vision", **tag, model="vit_b16", rows=DPV_VIT_ROWS,
        **_step_summary(vstep, vtimes, vcalls, vsteady),
        images_per_s=f"{DPV_VIT_ROWS / statistics.median(vsteady):.1f}",
        timed_data_stalls=vstalls, replicas_equal=True)
    out.update(vit_ms=[t * 1e3 for t in vsteady], vit_stalls=vstalls)
    # a captured graph holds its NCCL calls: free it before the group goes
    del vit, vstep
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx.close()
    with open(os.path.join(workdir, f"dp_vision_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    pmesh.shutdown()


def _dp_vision_cli(world: int, workdir: str, tar: str) -> None:
    """The launched CLI's ResNet arm on *world* cards: ``python -m
    torch.distributed.run --standalone --nproc-per-node <world> -m
    strom_torch.cli resnet --train-step --predecoded`` over the phase's
    tar, 128 rows a card. Rank 0 alone prints the JSON: devices the
    world, a finite loss."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(workdir, "dp_vision_cli")
    os.makedirs(d, exist_ok=True)
    batch = DPV_ROWS * world
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), "-m", "strom_torch.cli", "resnet",
         "--train-step", "--predecoded", "--file", tar, "--batch",
         str(batch), "--steps", "8", "--prefetch", "16", "--json",
         "--tmpdir", d], capture_output=True, text=True, env=env,
        timeout=CLI_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(__file__)))
    dt = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    cmd = f"torch.distributed.run --nproc-per-node {world} resnet"
    if proc.returncode or len(lines) != 1:
        _cli_fail(cmd, proc.returncode, proc.stderr[-3000:],
                  f"{len(lines)} JSON lines")
    out = json.loads(lines[0])
    if out["devices"] != world or not math.isfinite(out["train_loss"]):
        _cli_fail(cmd, 0, proc.stderr[-3000:], f"devices {out['devices']}, "
                  f"loss {out['train_loss']}")
    say("dp_vision", cli=cmd.replace(" ", "_"), s=f"{dt:.1f}", batch=batch,
        devices=out["devices"], train_loss=out["train_loss"],
        train_images_per_s=out["train_images_per_s"],
        train_data_stalls=out["train_data_stalls"],
        images_per_s=out["images_per_s"], card=_card_line(0).replace(" ", "_"))


def phase_dp_vision(workdir: str, pdec: str | None = None,
                    tar: str | None = None) -> None:
    """Phase 12c: the vision pipelines and the ResNet-50 and ViT-B/16 steps
    over every card (world 1 on a machine with one; world 1 and then
    world N on one with N), one worker a card (``dp_vision_worker``).
    *pdec* and *tar*: phase 6's predecoded shard and phase 7's tar (made
    here, seeded as those phases make them, when they did not run). Per
    world, each rank's median step ms and the losses (equal on every
    rank), then each model's weak-scaling ratio (world N's median step
    over world 1's), and on N cards the launched CLI's ResNet arm."""
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    made = []
    if pdec is None:
        rng = np.random.default_rng(6)
        pdec = os.path.join(workdir, "dp_vision.pdec")
        _write_predecoded(pdec, np.frombuffer(
            rng.bytes(DPV_RECORDS * RECORD), dtype=np.uint8).reshape(
                DPV_RECORDS, IMAGE, IMAGE, 3),
            rng.integers(0, 1000, DPV_RECORDS, dtype=np.int32))
        made.append(pdec)
    if tar is None:
        if not (jpeg._HAVE_CV2 or jpeg._HAVE_PIL):
            raise AssertionError(f"dp_vision: {NO_JPEG}")
        tar = os.path.join(workdir, "dp_vision.tar")
        _jpeg_fixture(tar, DPV_JPEGS, 448)
        made.append(tar)
    with open(os.path.join(workdir, "dp_vision.json"), "w") as f:
        json.dump({"pdec": pdec, "tar": tar}, f)
    medians: dict[str, dict[int, float]] = {"resnet": {}, "vit": {}}
    for world in ([1] if n == 1 else [1, n]):
        ranks = _spawn_ranks("--dp-vision-worker", "dp_vision", world,
                             workdir, DPV_TIMEOUT_S)
        for m in medians:
            medians[m][world] = statistics.median(
                statistics.median(r[f"{m}_ms"]) for r in ranks)
        losses = {tuple(r["losses"]) for r in ranks}
        say("dp_vision", world=world, cards=",".join(
            r["card"].replace(" ", "_") for r in ranks),
            resnet_step_ms_median=",".join(
                f"{statistics.median(r['resnet_ms']):.2f}" for r in ranks),
            resnet_images_per_s=f"{world * DPV_ROWS / medians['resnet'][world] * 1e3:.1f}",
            bn_allreduce_ms=",".join(f"{r['bn_allreduce_ms']:.3f}"
                                     for r in ranks),
            grad_allreduce_ms=",".join(f"{r['grad_allreduce_ms']:.3f}"
                                       for r in ranks),
            allreduce_share=",".join(f"{r['allreduce_share']:.4f}"
                                     for r in ranks),
            jpeg_images_per_s=",".join(f"{r['jpeg_images_per_s']:.1f}"
                                       for r in ranks),
            vit_step_ms_median=",".join(
                f"{statistics.median(r['vit_ms']):.2f}" for r in ranks),
            timed_data_stalls=",".join(str(r["stalls"]) for r in ranks),
            losses_equal=len(losses) == 1,
            **{f"rank0_max_{k}_rel_to_plain": f"{v:.3g}"
               for k, v in ranks[0]["plain_gap"].items()},
            **{f"rank0_local_bn_{k}_rel_to_plain": f"{v:.3g}"
               for k, v in ranks[0]["local_gap"].items()})
        if len(losses) != 1:
            raise AssertionError(f"dp_vision world {world}: the ranks report "
                                 f"different losses {losses}")
    for m, by_world in medians.items():
        say("dp_vision", model=m, worlds=",".join(map(str, by_world)),
            weak_scaling=f"{by_world[max(by_world)] / by_world[1]:.4f}",
            note="median step ms at the largest world over world 1's, the "
                 "same rows a card", card=_card_line(0).replace(" ", "_"))
    if n > 1:
        _dp_vision_cli(n, workdir, tar)
    _remove(*made)


# ------------------------------------------------------------------- dist
# the host-mode fleets' token fixture: Llama pretraining rows of 2,048
# int32 tokens (8 KiB), 4 shards of 1,024 rows (32 MiB); 32 rows a global
# batch, 16 steps (512 rows, half an epoch)
DIST_FILES, DIST_RECORDS, DIST_SEQ = 4, 1024, 2048
DIST_BATCH, DIST_STEPS = 32, 16
DIST_HOT_BYTES = 256 * MiB       # each worker's hot cache: its shards and
                                 # the rows its peers serve it
DIST_TIMEOUT_S = 120.0           # a fleet's rendezvous and join
DIST_DEVICE = "cuda"             # the frame arm's card ("cpu" rehearses it)
DIST_RESNET = ResNetConfig.resnet50()
DIST_FRAME_BATCH = 128
DIST_FRAME_WAIT_S = 300.0        # the frame server's life at most


def _dist_fleet(label: str, procs: int, workdir: str, data: str, *,
                batch: int = DIST_BATCH, **kw) -> dict:
    """One ``measure_ingest`` fleet over phase dist's fixture, judged: every
    judged worker bit-identical to ``reference_shard_hashes``
    (``dist_ok``), each delivering its own rows only, and, where no host
    is killed, no engine read during ingest. One line: the fleet's items/s,
    peer hit ratio, per-extent and p99 round trip, and each rank's
    assembly wait p50 and p99."""
    t0 = time.perf_counter()
    res = measure_ingest(procs, os.path.join(workdir, label),
                         data_dir=data, steps=DIST_STEPS, batch=batch,
                         seq_len=DIST_SEQ, engine="auto",
                         hot_cache_bytes=DIST_HOT_BYTES,
                         timeout_s=DIST_TIMEOUT_S, **kw)
    dt = time.perf_counter() - t0
    workers = res["workers"]
    killed = kw.get("die_rank", -1)
    say("dist", arm=label, mode=kw.get("mode", "host"), procs=procs,
        dist_ok=res["dist_ok"],
        dist_engine_ingest_bytes=res["dist_engine_ingest_bytes"],
        only_own_rows=res["dist_only_own_rows"],
        engines=",".join(str(w.get("engine")) for w in workers),
        items_per_s=res["dist_items_per_s"],
        dist_peer_hit_ratio=res["dist_peer_hit_ratio"],
        peer_hit_bytes=res["dist_peer_hit_bytes"],
        peer_rtt_per_extent_us=res["peer_rtt_per_extent_us"],
        peer_rtt_p99_us=res["dist_peer_rtt_p99_us"],
        peer_wire_bytes=res["dist_peer_wire_bytes"],
        peer_comp_ratio=res["peer_comp_ratio"],
        asm_wait_p50_us=",".join(f"{w.get('assembly_wait_p50_us', 0):.0f}"
                                 for w in workers),
        asm_wait_p99_us=",".join(f"{w.get('assembly_wait_p99_us', 0):.0f}"
                                 for w in workers),
        first_step_us=",".join(f"{w.get('first_step_us', 0):.0f}"
                               for w in workers),
        rank_items_per_s=",".join(str(w.get("items_per_s")) for w in workers),
        peer_errors=",".join(str(w.get("peer_errors", 0)) for w in workers),
        rcs=",".join(str(w.get("rc")) for w in workers), s=f"{dt:.1f}")
    bad = [w for i, w in enumerate(workers) if i != killed
           and (w.get("rc") != 0 or not w.get("ok"))]
    if not res["dist_ok"] or bad:
        raise AssertionError(f"dist {label}: a worker failed or diverged "
                             f"from the reference hashes: "
                             f"{[w.get('tail', w) for w in bad] or workers}")
    if not res["dist_only_own_rows"]:
        raise AssertionError(f"dist {label}: a worker delivered other rows "
                             f"than its own: {workers}")
    if killed < 0 and res["dist_engine_ingest_bytes"] != 0:
        raise AssertionError(f"dist {label}: the engines read "
                             f"{res['dist_engine_ingest_bytes']} bytes during "
                             "ingest: a row hot on its owner was read again")
    return res


def dist_frame_server(tar: str, workdir: str, batch: int) -> None:
    """Host A of the decoded-frame arm (its own process, as a worker is):
    one epoch of the JPEG tar through make_imagenet_resnet_pipeline with
    decode_cache on (full-resolution decode, admission always) onto the
    CPU, so its DecodedCache holds the frames; then it serves them to
    peers, writes its address and the frames it holds to
    <workdir>/frames_server.json, and serves until <workdir>/frames_stop
    exists."""
    ctx = StromContext(StromConfig.from_env(hot_cache_bytes=GiB,
                                            hot_cache_admit="always"))
    try:
        with make_imagenet_resnet_pipeline(
                ctx, [tar], batch=batch, device="cpu", decode_cache=True,
                decode_reduced_scale=False) as pipe:
            for _ in range(pipe.sampler.batches_per_epoch):
                next(pipe)
            held = pipe.stats().get("decode_cache_admitted_bytes", 0)
            frames = sum(v for k, v in pipe.stats().items()
                         if k.endswith("_imgs"))
        addr = ctx.serve_peers()
        tmp = os.path.join(workdir, "frames_server.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"addr": addr, "admitted_bytes": held,
                       "decoded": frames}, f)
        os.replace(tmp, os.path.join(workdir, "frames_server.json"))
        deadline = time.monotonic() + DIST_FRAME_WAIT_S
        while not os.path.exists(os.path.join(workdir, "frames_stop")) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        st = ctx.stats(["dist"])["dist"]
        with open(os.path.join(workdir, "frames_server_stats.json"),
                  "w") as f:
            json.dump(st, f)
    finally:
        ctx.close()


def _decodes(pipe) -> int:
    return sum(v for k, v in pipe.stats().items() if k.endswith("_imgs"))


def _dist_frames(workdir: str, tar: str) -> None:
    """Decoded frames cluster-wide: host A (``dist_frame_server``, another
    process) holds one epoch of the tar's decoded frames; host B feeds its
    JPEG ResNet-50 pipeline on the card, decode_cache on, first without
    peers, then peered with A (A owns every path). B's batches must be
    bit-equal, and with peers B must decode only the frames A did not
    hold. Each run feeds ResNet-50 steps (captured, warmed first on
    random batches): the step ms of both runs."""
    dev = torch.device(DIST_DEVICE)
    B = DIST_FRAME_BATCH
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = here
    code = ("import sys, chip_smoke as c; "
            "c.dist_frame_server(sys.argv[1], sys.argv[2], int(sys.argv[3]))")
    for f in ("frames_server.json", "frames_stop"):
        _remove(os.path.join(workdir, f))
    server = subprocess.Popen([sys.executable, "-c", code, tar, workdir,
                               str(B)], env=env, cwd=here)
    model = ResNet(DIST_RESNET, device=dev)
    step = make_resnet_sgd_step(DIST_RESNET, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    for _ in range(2):                 # eager, then the capture
        step(model, torch.randint(0, 256, (B, IMAGE, IMAGE, 3),
                                  generator=gen, device=dev,
                                  dtype=torch.uint8),
             torch.randint(0, 1000, (B,), generator=gen, device=dev,
                           dtype=torch.int32))
    kw = dict(batch=B, device=dev, decode_cache=True,
              decode_reduced_scale=False)
    runs = {}
    try:
        for arm in ("alone", "peered"):
            # admission always: a frame fetched from A is admitted at once
            ctx = StromContext(StromConfig.from_env(
                hot_cache_bytes=GiB, hot_cache_admit="always"))
            try:
                if arm == "peered":
                    info_path = os.path.join(workdir, "frames_server.json")
                    deadline = time.monotonic() + DIST_FRAME_WAIT_S
                    while not os.path.exists(info_path):
                        if server.poll() is not None \
                                or time.monotonic() > deadline:
                            raise AssertionError(
                                "dist frames: host A ended without serving "
                                f"(rc {server.poll()})")
                        time.sleep(0.05)
                    with open(info_path) as f:
                        info = json.load(f)
                    ctx.attach_peers({0: info["addr"]},
                                     owner_fn=lambda path: 0)
                with make_imagenet_resnet_pipeline(ctx, [tar], **kw) as pipe:
                    bpe = pipe.sampler.batches_per_epoch
                    got, times, dt = _epoch(f"dist frames {arm}", pipe, bpe,
                                            model, step, train=True)
                    runs[arm] = (got, times, dt, _decodes(pipe), bpe)
                    if arm == "peered":
                        fetched = ctx.stats(["dist"])["dist"]
            finally:
                ctx.close()
    finally:
        with open(os.path.join(workdir, "frames_stop"), "w"):
            pass
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    _same_batches("dist frames peered", runs["peered"][0], runs["alone"][0])
    n = runs["alone"][4] * B
    held = info["decoded"]
    for arm, (_, times, dt, decodes, bpe) in runs.items():
        say("dist", arm=f"frames_{arm}", device=str(dev), samples=n,
            batches=bpe, decodes=decodes, images_per_s=f"{bpe * B / dt:.1f}",
            **_step_ms(times),
            **({"peer_frame_hits": fetched["peer_frame_hits"],
                "peer_frame_hit_bytes": fetched["peer_frame_hit_bytes"],
                "host_a_decoded": held,
                "host_a_admitted_bytes": info["admitted_bytes"]}
               if arm == "peered" else {}))
    alone_dec, peered_dec = runs["alone"][3], runs["peered"][3]
    want = max(n - fetched["peer_frame_hits"], 0)
    if alone_dec != n or peered_dec != want or fetched["peer_frame_hits"] \
            != min(held, n):
        raise AssertionError(
            f"dist frames: B decoded {peered_dec} of {n} frames with peers "
            f"(alone {alone_dec}); A held {held}, served "
            f"{fetched['peer_frame_hits']}")
    say("dist", arm="frames", check="peered batches bit-equal to the run "
        "without peers; B decoded only the frames A did not hold",
        exact=True, card=_card_line(0).replace(" ", "_"))


def phase_dist(workdir: str, tar: str | None = None) -> None:
    """Phase 14: the peer fabric. Host mode on this machine: measure_ingest
    at 1, 2 and 4 worker processes (the default engine; io_uring where the
    machine grants it, else the preadv pool), then at 4 the batched wire
    against batch_extents=0 and against peer_compress, and a host killed
    at 3 (rank 1 after step 2: the survivors bit-identical, its dead_1
    marker written). Then the decoded-frame arm on card 0 (phase 7's tar,
    made here when it did not run), the CLI's dist at 2 processes, and on
    a machine with 4 cards or more the mesh mode at 4: one worker a card,
    each rank's slice delivered with memcpy_ssd2gpu(sharding=), then the
    CLI's dist --mode mesh."""
    data = os.path.join(workdir, "dist_data")
    make_fixture(data, files=DIST_FILES, records=DIST_RECORDS,
                 seq_len=DIST_SEQ, seed=7)
    say("dist", fixture_files=DIST_FILES, rows=DIST_FILES * DIST_RECORDS,
        row_bytes=DIST_SEQ * 4, batch=DIST_BATCH, steps=DIST_STEPS,
        hot_cache_bytes=DIST_HOT_BYTES)
    one = _dist_fleet("single", 1, workdir, data)
    fleets = {p: _dist_fleet(f"host{p}", p, workdir, data) for p in (2, 4)}
    for p, res in fleets.items():
        say("dist", arm=f"host{p}", dist_vs_single=
            f"{res['dist_items_per_s'] / one['dist_items_per_s']:.3f}")
    unb = _dist_fleet("host4_unbatched", 4, workdir, data, batch_extents=0)
    comp = _dist_fleet("host4_compressed", 4, workdir, data,
                       peer_compress=True)
    raw_wire = fleets[4]["dist_peer_wire_bytes"]
    say("dist", arm="host4_ab", dist_batch_vs_single=
        f"{fleets[4]['dist_items_per_s'] / unb['dist_items_per_s']:.3f}",
        dist_peer_comp_vs_raw=f"{raw_wire / comp['dist_peer_wire_bytes']:.4f}"
        if comp["dist_peer_wire_bytes"] else "none",
        dist_comp_items_per_s=comp["dist_items_per_s"])
    # 30 rows a batch: 10 a host
    _dist_fleet("host3_kill", 3, workdir, data, batch=DIST_BATCH // 3 * 3,
                die_rank=1, die_after_step=2)
    if not os.path.exists(os.path.join(workdir, "host3_kill", "run3",
                                       "dead_1")):
        raise AssertionError("dist host3_kill: no dead_1 marker")
    say("dist", arm="host3_kill", check="survivors bit-identical, dead_1 "
        "written", exact=True)
    made = None
    if tar is None:
        if not (jpeg._HAVE_CV2 or jpeg._HAVE_PIL):
            raise AssertionError(f"dist: {NO_JPEG}")
        tar = made = os.path.join(workdir, "dist.tar")
        _jpeg_fixture(tar, 512, 448)
    _dist_frames(workdir, tar)
    _remove(made)
    rc, out, _, dt, err = _cli_run(
        ["dist", "--procs", "2", "--json", "--engine", "auto",
         "--tmpdir", os.path.join(workdir, "cli_dist")])
    say("dist", arm="cli", cmd="dist --procs 2", rc=rc,
        dist_ok=out.get("dist_ok"), dist_vs_single=out.get("dist_vs_single"),
        dist_engine_ingest_bytes=out.get("dist_engine_ingest_bytes"),
        s=f"{dt:.1f}")
    if rc != 0 or out.get("dist_ok") != 1:
        _cli_fail("dist", rc, err, "not dist_ok 1")
    n = torch.cuda.device_count()
    if n < 4:
        say("dist", arm="mesh4", skipped=f"{n}_card(s):_mesh_mode_needs_4")
        return
    res = _dist_fleet("mesh4", 4, workdir, data, mode="mesh")
    say("dist", arm="mesh4", cards=",".join(
        str(w.get("card")).replace(" ", "_") for w in res["workers"]))
    rc, out, _, dt, err = _cli_run(
        ["dist", "--mode", "mesh", "--procs", "4", "--json", "--engine",
         "auto", "--tmpdir", os.path.join(workdir, "cli_dist_mesh")])
    say("dist", arm="cli_mesh", cmd="dist --mode mesh --procs 4", rc=rc,
        dist_ok=out.get("dist_ok"), only_own_rows=out.get(
            "dist_only_own_rows"), s=f"{dt:.1f}")
    if rc != 0 or out.get("dist_ok") != 1 \
            or out.get("dist_only_own_rows") != 1:
        _cli_fail("dist --mode mesh", rc, err, "not dist_ok 1 on own rows")


# -------------------------------------------------------------- tp_sp (12d)
# arm -> (mesh axes, sp, attn, global batch rows, tokens a row), phase 4's
# model (DP_CONFIG): on one card the plumbing at 1 x 2048; on four, tp over
# the heads (8 q and 2 kv heads a rank), sp over Llama-3-8B's context of
# 8192 (S_l 2048) with the flash and the zigzag rings, and both at 2 x 4096
# (16 q and 4 kv heads a rank, S_l 2048)
TPSP_ARMS = {
    1: {"one": ({"dp": 1, "tp": 1, "sp": 1}, True, "flash", 1, 2048)},
    4: {"tp4": ({"tp": 4}, False, "flash", 2, 2048),
        "sp4_flash": ({"sp": 4}, True, "flash", 1, 8192),
        "sp4_zigzag": ({"sp": 4}, True, "zigzag", 1, 8192),
        "tp2sp2": ({"tp": 2, "sp": 2}, True, "flash", 2, 4096)},
}
# rank 0's counted (loss, grad_norm) against make_train_step without a mesh
# on the global batch from the same parameters, relative. A sound run on
# four H100s: world 1 equal bit for bit; at world 4 at most 2.88e-5 and
# 1.46e-4 (tp4: each row-parallel matmul's halves summed in bf16 across
# ranks; the rings merge bf16 block outputs in f32). A step that skipped
# the sum over sp (or summed a tp shard's squares twice) reports a loss or
# grad_norm off by a factor: a relative error of 0.3 or more.
TPSP_PLAIN_RTOL = {"loss": 2e-4, "grad_norm": 1e-3}
# a rank's block in the ring check: the sp4 arms' q block (Llama-3-8B's
# heads), bf16, the kernels' ring against the dense ring in f32
TPSP_RING_SHAPE = (1, 2048, 32, 8, 128)


def _tp_sp_launches(axes: dict, sp: bool, attn: str, sp_index: int
                    ) -> dict[str, int]:
    """Each kernel's launches in one step of an arm on the rank of
    *sp_index*: the forward runs twice a layer (remat), each backward once.
    The flash ring runs the diagonal block and the sp_index earlier ones
    (later ones are hidden and skipped), a pair of backward kernels each;
    zigzag runs 3 half-length calls at its own kv pair and 2 at each other
    (one of the two that causality decides is hidden)."""
    n = axes.get("sp", 1) if sp else 1
    calls = 3 + 2 * (n - 1) if attn == "zigzag" and n > 1 else 1 + sp_index
    layers = DP_CONFIG.n_layers
    return {"fa_fwd": 2 * layers * calls, "fa_bwd_dkv": layers * calls,
            "fa_bwd_dq": layers * calls}


def _ring_grads(fn, q, k, v, g):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(g)
    return out.detach(), q.grad, k.grad, v.grad


def _ring_check(mesh, impl: str, rank: int) -> dict[str, float]:
    """The ring of *impl* over the mesh's sp axis on this rank's bf16 block
    (TPSP_RING_SHAPE): the kernels with the global lse and delta against
    the dense ring (the plain version) in f32 on the same inputs: out and
    the gradients of sum(out * g), at BF16_VS_F32_TOL."""
    from strom_torch.parallel.ring import make_ring_attention

    q, k, v, g = _inputs(*TPSP_RING_SHAPE, torch.bfloat16, 100 + rank)
    got = _ring_grads(make_ring_attention(mesh, impl=impl), q, k, v, g)
    want = _ring_grads(make_ring_attention(mesh, impl="dense"),
                       *(t.float() for t in (q, k, v, g)))
    rtol, frac, _ = BF16_VS_F32_TOL
    errs = {name: _close(f"tp_sp ring {impl} rank {rank} {name}", a, b,
                         rtol, frac)
            for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    say("tp_sp", rank=rank, check=f"ring_{impl}_vs_dense_ring_f32",
        shape=json.dumps(list(TPSP_RING_SHAPE)).replace(" ", ""),
        tol="BF16_VS_F32_TOL",
        **{f"{k}_max_abs_err": f"{e:.4g}" for k, e in errs.items()})
    del q, k, v, g, got, want
    torch.cuda.empty_cache()
    return errs


# ------------------------------------------------------------------ ep (12e)
# Llama-3-8B's attention at 2 of 32 layers (phase 4's) with 8 SwiGLU
# experts of d_ff 14,336 at d_model 4,096 a layer: the expert shape of
# Mixtral-8x7B's public config (mistralai/Mixtral-8x7B-v0.1), routed top-1
# as the reference routes, capacity factor 1.25; 3.95 B parameters, about
# 31.6 GB with bf16 gradients and AdamW moments
EP_CONFIG = MoEConfig(base=DP_CONFIG, n_experts=8)
# arm -> (mesh axes or None, sp, attn, global batch rows, tokens a row).
# World 1: the step without a mesh and on {"ep": 1}, which must be the same
# step bit for bit. World 4: the dry run's dp x ep layout at 4 devices
# (strom/parallel/dryrun.py:124-127) and its dp x ep x sp configuration
# (:147-170) cut to 4 cards, both attention "flash" (the ring over sp)
EP_ARMS = {
    1: {"meshless": (None, False, "flash", 2, 2048),
        "ep1": ({"ep": 1}, False, "flash", 2, 2048)},
    4: {"dp2ep2": ({"dp": 2, "ep": 2}, False, "flash", 4, 2048),
        "ep2sp2": ({"ep": 2, "sp": 2}, True, "flash", 2, 4096)},
}
# rank 0's counted (loss, grad_norm) against make_moe_train_step without a
# mesh on the global batch from the same parameters, relative. Set before
# the first four-card run: attention of 2 rows (dp2ep2) or a ring of two
# blocks merged in f32 (ep2sp2) rounds bf16 activations otherwise than the
# plain step's 4 rows or whole rows, so a token whose two largest router
# logits nearly tie may take another expert, which moves the queue places
# of the tokens after it in that expert (a handful of tokens of 8,192;
# counted as experts_differ). Such a token changes the loss by about its
# own share, 1e-4 of it, and the gradient norm about ten times more. A step
# that summed the experts' outputs over ep twice or not at all, or counted
# the aux losses ep times, misses the loss by 0.1 or more of it; one that
# summed the expert gradients' squares twice, the norm by 0.05 or more.
EP_PLAIN_RTOL = {"loss": 1e-3, "grad_norm": 1e-2}


def _ep_routes(model, tokens: torch.Tensor, attn_fn, positions, layout
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each layer's (expert, keep) of *tokens* through *model* without
    gradients (no remat): two [layers, tokens] tensors."""
    routes: list = []
    with torch.no_grad():
        model(tokens, positions=positions, attn_fn=attn_fn, layout=layout,
              routes=routes)
    return (torch.stack([e for e, _ in routes]),
            torch.stack([k for _, k in routes]))


def _ep_load(experts: torch.Tensor, keep: torch.Tensor) -> dict[str, str]:
    """The dropped-token share and the largest expert's load over the
    capacity C of a global batch's routes ([layers, N]), each the largest
    over the layers."""
    n = experts.shape[1]
    counts = torch.stack([torch.bincount(e, minlength=EP_CONFIG.n_experts)
                          for e in experts])
    return {"dropped_share": f"{1 - keep.float().mean(1).min().item():.4f}",
            "max_load_over_c": f"{counts.max().item() / EP_CONFIG.capacity(n):.3f}",
            "capacity": EP_CONFIG.capacity(n)}


# ------------------------------------------------ the mesh arms (12d, 12e)
@dataclasses.dataclass(frozen=True)
class MeshPhase:
    """What phases 12d and 12e set for the arms that ``_mesh_arm`` runs.
    *arms*: world -> arm -> (mesh axes or None, sp, attn, global batch
    rows, tokens a row); *rtol*: rank 0's counted (loss, grad_norm)
    against the step without a mesh, relative; the ranks of one
    coordinate of *shard_axis* hold equal blocks, and every rank the
    parameters *replicated* names; *init(dev, mesh)* and *make_step(attn,
    dev, mesh, sp)* make the state and the step; *routes*, for the MoE,
    gives each layer's (expert, keep) of a batch (``_ep_routes``);
    *before(rank, world)*, at world 4, runs on each rank before the
    arms."""
    name: str
    flag: str
    arms: dict
    rtol: dict
    shard_axis: str
    vocab: int
    layers: int
    seed: int
    init: Callable
    make_step: Callable
    replicated: Callable[[str], bool]
    routes: Callable | None = None
    before: Callable | None = None
    counted: int = 4     # warm-up, capture, 2 replays
    timed: int = 4
    epoch: int = 4       # global batches in an arm's token file
    timeout_s: float = 900   # a world's workers, all its arms


def _token_file(ph: MeshPhase, world: int, arm: str) -> str:
    """An arm's token file: one for all arms of world 1 (a meshless arm
    and the arms that must equal it read the same rows)."""
    return f"{ph.name}_{world}.bin" if world == 1 else f"{ph.name}_{arm}.bin"


def _mesh_plain(ph: MeshPhase, dev: torch.device,
                batches: list[torch.Tensor]) -> dict:
    """The phase's step without a mesh on one card from its state of seed
    0, a step a global batch: each step's {loss, grad_norm}, the median ms
    of as many more replays (timed on the host around each, the card
    synchronised), and with *routes* the first batch's routes at the
    initial parameters. Its state is freed after."""
    state = ph.init(dev, None)
    out: dict = {}
    if ph.routes is not None:
        out["experts"], out["keep"] = ph.routes(
            state.model, batches[0], fa.make_flash_attention(), None, None)
    step = ph.make_step("flash", dev, None, False)
    metrics, times = [], []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: m[k].item() for k in ("loss", "grad_norm")})
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, b)[1]["loss"].item()
        times.append(time.perf_counter() - t0)
    del state, step
    torch.cuda.empty_cache()
    return {**out, "metrics": metrics, "ms": statistics.median(times) * 1e3}


def _share_plain(ph: MeshPhase, plain: dict | None, n: int,
                 dev: torch.device) -> dict:
    """Rank 0's *plain* (None on the other ranks) as every rank sees it:
    its ms and routes (of *n* tokens) broadcast, its metrics rank 0's."""
    ms = torch.zeros(1, device=dev)
    routes = torch.zeros(2, ph.layers, n, dtype=torch.int64, device=dev) \
        if ph.routes is not None else None
    if plain is not None:
        ms[0] = plain["ms"]
        if routes is not None:
            routes[0], routes[1] = plain["experts"], plain["keep"].long()
    torch.distributed.broadcast(ms, src=0)
    shared = {"ms": ms.item()}
    if routes is not None:
        torch.distributed.broadcast(routes, src=0)
        shared.update(experts=routes[0], keep=routes[1] > 0)
    return {**(plain or {}), **shared}


def _mesh_arm(ph: MeshPhase, arm: str, rank: int, world: int, workdir: str,
              dev: torch.device, card: str, plain: dict | None) -> dict:
    """One arm of phase 12d or 12e on this rank (their docstrings).
    *plain*: world 1's meshless arm, which a later arm of world 1 must
    equal bit for bit; for an arm on a mesh without it, rank 0 runs the
    step without a mesh here first."""
    from strom_torch.models.llama import shard_positions
    from strom_torch.parallel import mesh as pmesh
    from strom_torch.parallel.expert_parallel import token_layout
    from strom_torch.parallel.ring import make_ring_attention
    from strom_torch.parallel.sharding import batch_sharding

    axes, sp, attn, B, L = ph.arms[world][arm]
    tag = {"arm": arm, "world": world, "rank": rank,
           "card": card.replace(" ", "_")}
    mesh = pmesh.make_mesh(axes) if axes is not None else None
    sharding = batch_sharding(mesh, sp=sp) if mesh is not None else None
    index = (next(iter(sharding.addressable_devices_indices_map(
        (B, L)).values())) if sharding is not None
        else (slice(None), slice(None)))
    path = os.path.join(workdir, _token_file(ph, world, arm))
    records = torch.from_numpy(np.fromfile(path, dtype=np.int32)
                               .reshape(-1, L)).to(dev)
    sampler = iter(EpochShuffleSampler(len(records), B, seed=0))
    orders = [torch.from_numpy(next(sampler)).to(dev)
              for _ in range(ph.counted + ph.timed)]
    if plain is None and mesh is not None:
        # before this rank's state exists, so that one card holds one model
        if rank == 0:
            plain = _mesh_plain(ph, dev, [records[o]
                                          for o in orders[:ph.counted]])
        plain = _share_plain(ph, plain, B * L, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ctx = StromContext(StromConfig.from_env())
    eng0 = ctx.engine.stats()["bytes_read"]
    xfer0 = ctx.stats()["context"]["transfers"]
    pipe = make_llama_pipeline(ctx, [path], batch=B, seq_len=L - 1,
                               sharding=sharding, seed=0)
    state = ph.init(dev, mesh)
    experts = keep = None
    if ph.routes is not None:
        block0 = records[orders[0]][index]
        experts, keep = ph.routes(
            state.model, block0,
            make_ring_attention(mesh, impl=attn) if sp
            else fa.make_flash_attention(),
            shard_positions(block0, mesh.axis("sp") if sp else None),
            token_layout(mesh, sp))
    step = ph.make_step(attn, dev, mesh, sp)
    names = [n for n, _ in state.model.named_parameters()]
    replicated = torch.tensor([ph.replicated(n) for n in names], device=dev)

    def coord(r: int) -> int:
        if mesh is None or ph.shard_axis not in mesh.axis_names:
            return 0
        return mesh.coords(r)[mesh.axis_names.index(ph.shard_axis)]

    twins = [min(s for s in range(world) if coord(s) == coord(r))
             for r in range(world)]
    fa.reset_launch_counts()
    times, calls, losses, metrics_all, variants, rels = [], [], [], [], {}, []
    sums = torch.empty(world, len(names), dtype=torch.int64, device=dev)
    for i in range(ph.counted + ph.timed):
        batch = next(pipe)
        local = batch.to_local() if sharding is not None else batch
        if tuple(batch.shape) != (B, L) or local.device != dev \
                or not torch.equal(local, records[orders[i]][index]):
            raise AssertionError(f"{ph.name} {arm} rank {rank} step {i}: the "
                                 "block differs from the file's rows in "
                                 "sampler order")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        calls.append(step.last_call)
        got = {"loss": loss, "grad_norm": metrics["grad_norm"].item()}
        losses.append(loss)
        metrics_all.append(got)
        want = plain["metrics"][i] if plain is not None \
            and i < len(plain.get("metrics", ())) else None
        rel = {f"{k}_rel_to_plain": abs(got[k] - want[k]) / abs(want[k])
               for k in got} if want is not None else {}
        rels.append(rel)
        if mesh is not None:
            torch.distributed.all_gather_into_tensor(
                sums.view(-1), _param_checksum(state.model))
        else:
            sums[0] = _param_checksum(state.model)
        equal = all(torch.equal(sums[r], sums[twins[r]]) and torch.equal(
            sums[r][replicated], sums[0][replicated]) for r in range(world))
        say(ph.name, **tag, step=i, call=step.last_call, loss=f"{loss:.5f}",
            grad_norm=f"{got['grad_norm']:.5f}", ms=f"{times[-1] * 1e3:.2f}",
            replicas_equal=equal,
            **({"plain_loss": f"{want['loss']:.5f}",
                "plain_grad_norm": f"{want['grad_norm']:.5f}",
                **{k: f"{v:.3g}" for k, v in rel.items()}} if rel else {}))
        if not (equal and math.isfinite(loss)):
            raise AssertionError(f"{ph.name} {arm} rank {rank} step {i}: "
                                 f"loss {loss}, checksums {sums.tolist()}")
        if rel and any(rel[f"{k}_rel_to_plain"] > tol
                       for k, tol in ph.rtol.items()):
            raise AssertionError(f"{ph.name} {arm} rank {rank} step {i}: "
                                 f"{got} against the step without a mesh "
                                 f"{want} (relative tolerance {ph.rtol})")
        if i == ph.counted - 1:
            variants = dict(fa.VARIANT_LAUNCHES)
    launched = check_variants(KERNELS, variants,
                              f"{ph.name} {arm} steps of rank {rank}")
    expected = {k: ph.counted * n for k, n in _tp_sp_launches(
        axes or {}, sp, attn, mesh.axis_index("sp") if sp else 0).items()}
    if launched != expected:
        raise AssertionError(f"{ph.name} {arm} rank {rank}: launched "
                             f"{launched} in {ph.counted} steps, want "
                             f"{expected}")
    routed: dict = {}
    if experts is not None:
        # this rank's routes against the plain step's of the global batch
        # at the same places, from the same parameters
        global_routes = (experts, keep)
        if plain is not None:
            pe, pk = (plain[k].view(ph.layers, B, L)[(slice(None), *index)]
                      .reshape(ph.layers, -1) for k in ("experts", "keep"))
            routed = {"experts_differ": int((pe != experts).sum()),
                      "keep_differ": int((pk != keep).sum())}
            global_routes = (plain["experts"], plain["keep"])
        routed.update(_ep_load(*global_routes))
    steady = times[ph.counted:]
    batch = next(pipe)
    if mesh is None:
        profile_step(step, state, batch)   # the cell's device time by group
    prof = _dp_profile(lambda: step(state, batch)[1]["loss"])
    pipe.close()
    nbytes = ctx.engine.stats()["bytes_read"] - eng0
    xfers = ctx.stats()["context"]["transfers"] - xfer0
    ctx.close()
    own = B * L * 4 if sharding is None \
        else math.prod(sharding.shard_shape((B, L))) * 4
    median = statistics.median(steady) * 1e3
    plain_ms = plain["ms"] if plain is not None else median
    nccl = {op: prof["nccl_ms"].get(op, 0.0)
            for op in ("AllReduce", "AllGather", "SendRecv")}
    peak = torch.cuda.max_memory_allocated(dev)
    say(ph.name, **tag, **_step_summary(step, times, calls, steady),
        step_ms_min=f"{min(steady) * 1e3:.2f}",
        step_ms_max=f"{max(steady) * 1e3:.2f}",
        tokens_per_s=f"{B * L / median * 1e3:.1f}", **routed,
        **{f"{op.lower()}_ms": f"{ms:.3f}" for op, ms in nccl.items()},
        **{f"{op.lower()}_share": f"{ms / prof['wall_ms']:.4f}"
           for op, ms in nccl.items()},
        profiled_step_ms=f"{prof['wall_ms']:.2f}",
        device_busy_ms=f"{prof['device_ms']:.2f}",
        plain_step_ms=f"{plain_ms:.2f}",
        plain_over_arm=f"{plain_ms / median:.4f}",
        peak_mem_gb=f"{peak / 1e9:.2f}",
        engine_bytes_read=nbytes, deliveries=xfers, block_bytes=own,
        only_own_rows=nbytes == xfers * own,
        launches_a_step=json.dumps({k: n // ph.counted for k, n in
                                    launched.items()}).replace(" ", ""))
    if nbytes != xfers * own:
        raise AssertionError(f"{ph.name} {arm} rank {rank}: read {nbytes} "
                             f"bytes in {xfers} deliveries of {own} (own "
                             "block only)")
    final = sums[rank].clone()
    # the graphs go before the groups they captured
    del state, step, records, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"step_ms": [t * 1e3 for t in steady], "losses": losses,
            "metrics": metrics_all, "rels": rels, "launches": launched,
            "nccl_ms": nccl, "wall_ms": prof["wall_ms"], "ms": median,
            "plain_ms": plain_ms, "bytes": nbytes, "deliveries": xfers,
            "peak_bytes": peak, "experts_differ": routed.get(
                "experts_differ"), "final_checksum": final,
            "experts": experts, "keep": keep}


def _mesh_worker(ph: MeshPhase, rank: int, world: int, port: int,
                 workdir: str) -> None:
    """One rank of phase 12d or 12e on card *rank*: at world 4 the phase's
    *before* first, then every arm of its world. At world 1 an arm after
    a meshless one must equal it bit for bit: each step's loss and grad
    norm, the final parameters and the routes. Writes its numbers to
    <name>_rank<rank>.json in *workdir*."""
    import gc

    from strom_torch.parallel import mesh as pmesh

    os.environ["LOCAL_RANK"] = str(rank)
    pmesh.init_distributed("cuda", rank=rank, world_size=world,
                           init_method=f"tcp://localhost:{port}")
    dev = torch.device("cuda", rank)
    card = _card_line(rank)
    out: dict = {"card": card, "arms": {}}
    if world > 1 and ph.before is not None:
        out.update(ph.before(rank, world))
    meshless = None
    for arm, (axes, *_) in ph.arms[world].items():
        res = _mesh_arm(ph, arm, rank, world, workdir, dev, card, meshless)
        if world == 1 and axes is None:
            meshless = res
        elif meshless is not None:
            same = {"metrics": res["metrics"] == meshless["metrics"],
                    "final_params": torch.equal(res["final_checksum"],
                                                meshless["final_checksum"])}
            if res["experts"] is not None:
                same["routes"] = torch.equal(
                    res["experts"], meshless["experts"]) and torch.equal(
                    res["keep"], meshless["keep"])
            say(ph.name, arm=arm, world=1, check="the mesh step against "
                "the meshless one, bit for bit", **same)
            if not all(same.values()):
                raise AssertionError(f"{ph.name} {arm}: the step on the mesh "
                                     f"differs from the step without one: "
                                     f"{same}")
        out["arms"][arm] = {k: v for k, v in res.items() if k not in (
            "final_checksum", "experts", "keep")}
        gc.collect()
    with open(os.path.join(workdir, f"{ph.name}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    pmesh.shutdown()


def _mesh_phase(ph: MeshPhase, workdir: str
                ) -> dict[str, dict[str, list[int]]]:
    """Phase 12d or 12e: world 1 and, on a machine with four cards or more,
    world 4, one worker a card (``_mesh_worker``), the parent having built
    the kernels. Per arm the ranks' median step ms, tokens/s, the plain
    step's ms over the arm's, the NCCL shares, and the losses equal on
    every rank (they must be). Returns each arm's launches by row of
    KERNELS, a list over the ranks."""
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()   # card 0's worker shares it with this process
    rng = np.random.default_rng(ph.seed)
    launches: dict[str, dict[str, list[int]]] = {}
    for world in [1] + ([4] if n >= 4 else []):
        for arm, (*_, B, L) in ph.arms[world].items():
            path = os.path.join(workdir, _token_file(ph, world, arm))
            if not os.path.exists(path):
                rng.integers(0, ph.vocab, (ph.epoch * B, L),
                             dtype=np.int32).tofile(path)
        ranks = _spawn_ranks(ph.flag, ph.name, world, workdir, ph.timeout_s)
        for arm, (axes, sp, attn, B, L) in ph.arms[world].items():
            rs = [r["arms"][arm] for r in ranks]
            losses = {tuple(r["losses"]) for r in rs}
            medians = [statistics.median(r["step_ms"]) for r in rs]
            say(ph.name, arm=arm, world=world, mesh=json.dumps(axes).replace(
                " ", ""), sp=sp, attn=attn, batch=f"{B}x{L}",
                cards=",".join(r["card"].replace(" ", "_") for r in ranks),
                step_ms_median=",".join(f"{m:.2f}" for m in medians),
                tokens_per_s=f"{B * L / max(medians) * 1e3:.1f}",
                plain_step_ms=f"{rs[0]['plain_ms']:.2f}",
                plain_over_arm=f"{rs[0]['plain_ms'] / max(medians):.4f}",
                **{f"{op.lower()}_share": ",".join(
                    f"{r['nccl_ms'][op] / r['wall_ms']:.4f}" for r in rs)
                   for op in ("AllReduce", "AllGather", "SendRecv")},
                rel_to_plain=",".join(
                    f"{v['loss_rel_to_plain']:.3g}/"
                    f"{v['grad_norm_rel_to_plain']:.3g}"
                    for v in rs[0]["rels"] if v) or "none",
                **({"experts_differ": ",".join(
                    str(r["experts_differ"]) for r in rs)}
                   if ph.routes is not None else {}),
                peak_mem_gb=",".join(f"{r['peak_bytes'] / 1e9:.2f}"
                                     for r in rs),
                losses_equal=len(losses) == 1)
            if len(losses) != 1:
                raise AssertionError(f"{ph.name} {arm}: the ranks report "
                                     f"different losses {losses}")
            launches[arm] = {name: [r["launches"][name] for r in rs]
                             for name in KERNELS}
    if n < 4:
        say(ph.name, world=4, skipped=f"{n}_card_machine")
    return launches


def _ring_checks(rank: int, world: int) -> dict:
    """Phase 12d's first step at world 4: the flash and zigzag rings over
    sp against the dense ring (``_ring_check``)."""
    from strom_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh({"sp": world})
    return {"ring_check": {impl: _ring_check(mesh, impl, rank)
                           for impl in ("flash", "zigzag")}}


TP_SP = MeshPhase(
    name="tp_sp", flag="--tp-sp-worker", arms=TPSP_ARMS,
    rtol=TPSP_PLAIN_RTOL, shard_axis="tp", vocab=DP_CONFIG.vocab,
    layers=DP_CONFIG.n_layers, seed=27,
    init=lambda dev, mesh: init_train_state(DP_CONFIG, device=dev, seed=0,
                                            mesh=mesh),
    make_step=lambda attn, dev, mesh, sp: make_train_step(
        DP_CONFIG, attn=attn, device=dev, mesh=mesh, sp=sp),
    replicated=lambda name: name.endswith("norm"), before=_ring_checks)


def _ep_replicated(name: str) -> bool:
    from strom_torch.models.moe import EXPERT_PARAMS

    return name not in EXPERT_PARAMS


EP = MeshPhase(
    name="ep", flag="--ep-worker", arms=EP_ARMS, rtol=EP_PLAIN_RTOL,
    shard_axis="ep", vocab=EP_CONFIG.base.vocab,
    layers=EP_CONFIG.base.n_layers, seed=29,
    init=lambda dev, mesh: init_moe_train_state(EP_CONFIG, device=dev,
                                                seed=0, mesh=mesh),
    make_step=lambda attn, dev, mesh, sp: make_moe_train_step(
        EP_CONFIG, attn=attn, device=dev, mesh=mesh, sp=sp),
    replicated=_ep_replicated, routes=_ep_routes)


# ------------------------------------------------------------------- main
# the phases --phases may choose: those that take nothing from another
STANDALONE = ("build", "kernels", "wide_path", "train", "ckpt", "dp",
              "dp_vision", "tp_sp", "ep", "dist")
MAIN_SHAPE = (2, 2048, 32, 8, 128)


def _library_covers(counter: str, kind: str | None) -> str | None:
    """What a row's library_ms times: SDPA's forward for fa_fwd (no note on
    the bf16 rows), SDPA's backward for the two backward kernels together;
    *kind* is the dtype of the rows timed with TF32 off."""
    if kind is None:
        return None if counter == "fa_fwd" else \
            "fa_bwd_dkv + fa_bwd_dq (SDPA backward)"
    if counter == "fa_fwd":
        return f"SDPA {kind} forward, TF32 off"
    return f"fa_bwd_dkv + fa_bwd_dq (SDPA {kind} backward, TF32 off)"


def kernels_line(res: dict) -> list[dict]:
    """The kernels line from the phases' results *res*: a row for each
    entry of KERNELS, WIDE_KERNELS, F32_KERNELS and DH512_KERNELS, its
    numbers from phase 2 at the row's shape and its launches from the one
    phase that drives its path: phase 2b for the Gemma-2 rows, phase 4 for
    the others, and each rank's from phases 12b, 12d and 12e beside the
    main path's rows (``launches_dp``, ``launches_tp_sp`` and
    ``launches_ep``, each arm's counts over its 4 counted steps). A phase that did not run gives null; without phase
    2 there are no rows."""
    rows = res.get("kernels")
    if rows is None:
        return []
    out = []
    for table, label, shape, src, kind in (
            (KERNELS, "main", None, "train", None),
            (WIDE_KERNELS, "gemma2_9b", GEMMA2_9B, "wide_path", None),
            (F32_KERNELS, "main_f32", MAIN_SHAPE, "train", "f32"),
            (DH512_KERNELS, "gemma2_9b_dh512", GEMMA2_9B_DH512, "train",
             "bf16")):
        launches = res.get(src)
        for name, info in table.items():
            row = {"name": name, "route": "cuda", "source": info["source"],
                   "design": info["design"], "replaces": info["replaces"],
                   "launches": None if launches is None else launches[name]}
            if table is KERNELS and "dp" in res:
                row["launches_dp"] = res["dp"][name]
            for phase in ("tp_sp", "ep"):
                if table is KERNELS and phase in res:
                    row[f"launches_{phase}"] = {
                        arm: counts[name] for arm, counts in
                        res[phase].items()}
            if shape is not None:
                row["shape"] = f"{label} {json.dumps(list(shape))}"
            row.update({k: rows[info["counter"]][label][k] for k in (
                "max_abs_err", "ms", "ms_min", "ms_max", "plain_ms",
                "bound_ms", "bound_by", "library_ms")})
            covers = _library_covers(info["counter"], kind)
            if covers is not None:
                row["library_covers"] = covers
            out.append(row)
    return out


def _remove(*paths: str | None) -> None:
    for p in paths:
        if p is not None:
            with contextlib.suppress(OSError):
                os.unlink(p)


def main(argv: list[str] | None = None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    workers = {"--dp-worker": dp_worker,
               "--dp-vision-worker": dp_vision_worker,
               **{ph.flag: functools.partial(_mesh_worker, ph)
                  for ph in (TP_SP, EP)}}
    if argv[:1] and argv[0] in workers:
        rank, world, port = (int(a) for a in argv[1:4])
        workers[argv[0]](rank, world, port, argv[4])
        return 0
    ap = argparse.ArgumentParser(description="Run the port's main path on "
                                 "the card and check it.")
    ap.add_argument("--phases", help="a comma list of phases to run alone, "
                    f"of {', '.join(STANDALONE)} (default: every phase)")
    args = ap.parse_args(argv)
    only = set(args.phases.split(",")) if args.phases else None
    if only is not None and not only <= set(STANDALONE):
        ap.error(f"--phases takes {', '.join(STANDALONE)}; got "
                 f"{', '.join(sorted(only - set(STANDALONE)))}")
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
    t_run = time.perf_counter()
    res: dict = {}

    def run(name: str, fn, *a):
        """Phase *name* in its place in the one order unless --phases
        leaves it out; its result is kept in *res* and returned. A phase
        left out returns None, which only phases that --phases cannot
        choose take as an argument."""
        if only is not None and name not in only:
            return None
        t0 = time.perf_counter()
        try:
            res[name] = fn(*a)
            return res[name]
        finally:
            say("phase", name=name, s=f"{time.perf_counter() - t0:.1f}",
                total_s=f"{time.perf_counter() - t_run:.1f}")

    try:
        run("build", phase_build)
        run("kernels", phase_kernels)
        run("wide_path", phase_wide_path)
        path = run("ssd2gpu", phase_ssd2gpu, workdir)
        disk_node = run("numa", phase_numa, path)
        run("train", phase_train, workdir)
        run("ckpt", phase_ckpt, workdir)
        run("stream", phase_stream, path)   # removes the file
        model, step, pdec = run("resnet", phase_resnet, workdir) or (None,) * 3
        tar = run("resnet_jpeg", phase_resnet_jpeg, workdir, model, step)
        run("auto_depth", phase_auto_depth, tar, model, step)
        run("cache", phase_cache, pdec)
        run("decoded_cache", phase_decoded_cache, tar, model, step)
        del model, step
        res.pop("resnet", None)
        torch.cuda.empty_cache()
        run("spill", phase_spill, workdir, pdec)
        run("vit", phase_vit, pdec, tar)
        pq = run("parquet", phase_parquet, workdir, tar)
        run("multitenant", phase_multitenant, workdir, pdec, pq)
        run("resilience", phase_resilience, workdir, pdec, tar)
        run("observability", phase_observability, workdir, tar)
        run("dp", phase_dp, workdir, pq)
        run("dp_vision", phase_dp_vision, workdir, pdec, tar)
        run("tp_sp", _mesh_phase, TP_SP, workdir)
        run("ep", _mesh_phase, EP, workdir)
        run("dist", phase_dist, workdir, tar)
        _remove(*(pq[0] if pq else ()), pdec, tar)
        run("cli", phase_cli, workdir, disk_node)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"kernels": kernels_line(res)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
