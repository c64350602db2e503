"""Configuration for the PyTorch port: the fields of ``strom.config`` that
the port reads, under the same names, defaults and ``STROM_*`` environment
overrides (``StromConfig.from_env``)."""

from __future__ import annotations

import dataclasses
import os
from typing import Any

KiB = 1024
MiB = 1024 * KiB

_ENV_PREFIX = "STROM_"


def _env_cast(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.strip().lower() in ("1", "true", "yes", "on")
    if typ is int:
        v = value.strip().lower()
        mult = 1
        for suffix, m in (("kib", KiB), ("mib", MiB), ("k", KiB), ("m", MiB)):
            if v.endswith(suffix):
                v = v[: -len(suffix)]
                mult = m
                break
        return int(v) * mult
    if typ is float:
        return float(value)
    return value


@dataclasses.dataclass(frozen=True)
class StromConfig:
    """Engine + delivery configuration (128 KiB chunks at queue depth 32,
    as the reference)."""

    # I/O engine
    block_size: int = 128 * KiB        # per-op transfer size (chunking unit)
    queue_depth: int = 32              # max in-flight ops per engine
    num_buffers: int = 64              # staging pool slots
    buffer_size: int = 0               # 0 → same as block_size
    o_direct: bool | None = None       # None → auto-probe per file
    engine: str = "auto"               # "auto" | "uring" | "python": auto
                                       # takes io_uring when the kernel
                                       # allows a ring, else the preadv pool
    mlock: bool = True                 # pin the engine's staging pool
    register_buffers: bool = True      # io_uring fixed buffers
    coop_taskrun: bool = True          # IORING_SETUP_COOP_TASKRUN (5.19+;
                                       # falls back when absent)
    engine_rings: int = 1              # independent io_uring rings: a
                                       # multi-file gather fans out per file
                                       # (RAID0 member i → ring i mod N)
    sqpoll: bool = False               # IORING_SETUP_SQPOLL: a kernel thread
                                       # polls the SQ (falls back when refused)
    ring_recovery_s: float = 0.0       # multi-ring quarantine cooldown: > 0
                                       # rebuilds a quarantined ring after
                                       # this many seconds and replays its
                                       # dest-slab registrations; 0 = sticky
    io_retries: int = 1                # per-chunk resubmits before erroring
    # route page-cache-resident ranges of a gather through the buffered fd
    # (a memcpy from the cache) instead of re-reading them O_DIRECT; both
    # the native engine and the preadv pool do
    residency_hybrid: bool = True
    raid_chunk: int = 512 * KiB        # RAID0 stripe chunk
    fault_every: int = 0               # fail every Nth op with EIO (tests)
    # retry backoff (engine/resilience.py): a failed transient piece waits
    # base * 2^attempts, jittered and capped at the max, before its
    # resubmit; the per-gather budget bounds the resubmits of one transfer
    io_retry_backoff_s: float = 0.005
    io_retry_backoff_max_s: float = 0.2
    io_retry_budget: int = 64
    # the longest a gather waits with no progress before it raises
    # EngineStallError naming the stuck ops
    engine_wait_timeout_s: float = 30.0
    # default request deadline in seconds (0 = none): a demand gather's
    # request carries it, and the scheduler's queue waits, the engine's
    # waits and the retry backoff stop at it (DeadlineExceeded). A
    # per-call deadline_s= wins
    request_deadline_s: float = 0.0
    # per-engine circuit breaker (delivery/resilient.py): trips open at an
    # error rate >= breaker_error_rate over a rolling window holding >=
    # breaker_min_events outcomes; while open, demand reads and failed
    # streamed chunks go to a fallback preadv pool; after the cooldown,
    # half-open probes (breaker_half_open_successes in a row) close it
    breaker_enabled: bool = True
    breaker_window_s: float = 10.0
    breaker_min_events: int = 8
    breaker_error_rate: float = 0.5
    breaker_cooldown_s: float = 5.0
    breaker_half_open_successes: int = 3
    # hedged reads (streamed gathers): a gather quiet for longer than
    # max(hedge_min_s, hedge_multiplier * rolling-p99 completion latency)
    # re-reads its incomplete chunks on the fallback path; the first
    # completion wins, the loser is cancelled. 0 multiplier and min disable
    hedge_enabled: bool = True
    hedge_min_s: float = 0.05
    hedge_multiplier: float = 3.0
    # a seeded fault plan (faults/plan.py): a JSON file path, an inline
    # JSON object or a preset ("chaos[:seed]", "chaos_writes[:seed]",
    # "chaos_net[:seed]"). Non-empty wraps the engine in FaultyEngine
    fault_plan: str = ""

    # observability
    # torch.profiler.record_function around delivery spans; the event
    # ring's spans follow the ring's own switch, not this one
    trace_annotations: bool = True
    # flight recorder (obs/flight.py): a non-empty flight_dir runs a
    # watchdog for the context's lifetime and dumps an atomic bundle there
    # on SIGTERM, an unhandled exception, a breaker trip, or no progress
    # for flight_stall_s seconds (<= 0 disables that trigger)
    flight_dir: str = ""
    flight_stall_s: float = 30.0
    # lock-order witness (utils/locks.py): every lock built through
    # make_lock after the context starts records its acquisition order and
    # raises LockOrderError on a cycle. Off = plain threading.Lock
    debug_locks: bool = False
    # the live endpoint (obs/server.py): > 0 serves /metrics (Prometheus),
    # /stats, /trace, /slo, /tune, /history, /tenants, /flight and
    # /cluster on 127.0.0.1:<port> for the context's lifetime. 0 = no
    # server (StromContext(metrics_port=0) asks for an ephemeral port)
    metrics_port: int = 0
    # snapshot history (obs/history.py): with the live server on, a thread
    # samples the process-wide registry every history_interval_s into a
    # bounded ring served on /history. <= 0 = no sampler (/history 404s)
    history_interval_s: float = 2.0

    # closed-loop knob autotuner (tune/): coordinate descent over the live
    # knob surfaces against goodput, with a guarded revert and a hold
    # while an SLO burns
    tune: bool = False                 # arm the tuner thread in the context
    tune_interval_s: float = 1.0       # settle window between moves
    tune_guard_frac: float = 0.10      # a move costing more than this
                                       # fraction of the objective reverts
                                       # and halves the knob's step
    tune_profile: str = ""             # JSON profile path, applied at
                                       # attach when it exists

    # NUMA affinity (multi-socket hosts): pin submitting threads to the
    # disk's home node, bind fresh staging slabs there before they are
    # pinned, optionally steer the device's IRQs (needs root). Off by
    # default; a no-op on one-node hosts (utils/numa.py)
    numa_affinity: bool = False
    numa_node: int = -1                # -1 = discover from the device
    irq_affinity: bool = False

    # delivery
    # extent-aware gather planning: split plain-file chunks at FIEMAP extent
    # boundaries and submit them in physical-address order (helps
    # fragmented files, a no-op on contiguous ones; one cached FIEMAP per
    # file)
    extent_aware: bool = True
    prefetch_depth: int = 2            # batches dispatched ahead of consumption
    prefetch_auto: bool = False        # auto-tune prefetch depth: grow on
                                       # data stalls, shrink when the queue
                                       # runs fully ready; prefetch_depth is
                                       # the STARTING depth
    prefetch_max_depth: int = 16       # auto-tune ceiling (further bounded by
                                       # slab-pool capacity per batch)
    delivery_workers: int = 2          # threads running async transfers
    # merge caller fragments contiguous in both file and dest space into
    # fewer engine ops; merged ops split at this cap (0 = off)
    coalesce_max_bytes: int = 32 * MiB
    # striped reads: member ops go out as per-member sequential runs within
    # windows of this many bytes; -1 = auto (queue_depth * block_size),
    # 0 = keep chunk-granular logical order
    stripe_window_bytes: int = -1
    slab_pool_bytes: int = 512 * MiB   # recycled pinned host slabs (0 = off);
                                       # used only for CUDA targets
    # intra-transfer streaming: read piece k+1 from disk while piece k is
    # copied host->device, for transfers >= overlap_min_bytes (0 = off)
    overlap_chunk_bytes: int = 128 * MiB
    overlap_min_bytes: int = 256 * MiB

    # host JPEG decode of the vision pipelines (formats/jpeg.py)
    # decode at 1/d (d in 2, 4, 8) when the sampled crop still covers the
    # target at that scale; the crop is sampled first, in full resolution
    decode_reduced_scale: bool = True
    # decode workers write their rows straight into the batch slot
    decode_to_slot: bool = True
    # put the batch the moment its rows finish decoding
    decode_overlap_put: bool = True
    # decode through the libjpeg-turbo binding of the native library when
    # it was built with one (formats/jpeg.native_available())
    decode_native: bool = True
    # one decode-pool task decodes a run of samples
    decode_fuse_runs: bool = True
    # decode only the crop's scanlines and iMCU columns (native path)
    decode_roi: bool = True
    # streamed batches (delivery/stream.py): each sample goes to the decode
    # pool the moment its extents land, not after the whole batch gather
    stream_intra_batch: bool = True
    # decoded-output cache (formats/decoded_cache.py): admit first-epoch
    # decode OUTPUT (full-frame RGB8, keyed by member extent and decoder)
    # into the hot cache, so a later epoch pays only crop and resize. Needs
    # hot_cache_bytes > 0; off by default (the decoded working set is ~5x
    # the compressed bytes)
    decode_cache: bool = False

    # hot-set host cache (delivery/hotcache.py): an extent-keyed,
    # byte-budgeted, refcounted LRU of physical byte ranges, consulted
    # before engine submission, so repeat traffic (epoch 2+) serves from
    # RAM instead of re-gathering from NVMe. 0 = off
    hot_cache_bytes: int = 0
    # admission: "second_touch" (the first epoch observes through a
    # block-granular touch ledger, the second admits) or "always"
    hot_cache_admit: str = "second_touch"
    # the touch ledger's quantum
    hot_cache_block_bytes: int = 1 * MiB
    # epoch-aware readahead: warm the sampler's next N batches into the hot
    # cache from a background thread that yields to demand reads (0 = off;
    # needs hot_cache_bytes > 0)
    readahead_window_batches: int = 0
    # NVMe spill tier (delivery/spill.py): hot-cache entries evicted under
    # byte pressure demote to a spill file of this many bytes instead of
    # vanishing, and the cache consult serves them from there (RAM → NVMe
    # → source). 0 = off; needs hot_cache_bytes > 0
    spill_bytes: int = 0
    # the spill file's directory ("" = the system temp dir); the file is
    # made per context and unlinked at close
    spill_dir: str = ""
    # spill I/O through the context's engine (O_DIRECT where the file
    # system allows it, scheduler-granted as the background tenant
    # "spill"); an op that would nest inside an outstanding exclusive grant
    # takes the spill file's buffered fd instead. Both routes are counted
    # (spill_engine_ops / spill_fallback_ops). Needs sched_enabled
    spill_engine_io: bool = True
    # compress demoted ranges with the probed codec (utils/codec.py) where
    # that pays; served bytes are unchanged
    spill_compress: bool = False

    # multi-tenant I/O scheduler (sched/): per-tenant queues with priority
    # classes and a weighted fair drain grant the engine one slice at a
    # time, in place of one engine lock per whole transfer. Off = that lock
    sched_enabled: bool = True
    # grant granularity: a gather runs as slices of this many bytes, one
    # grant each. -1 = auto (4 × queue_depth × block_size); 0 = no slicing
    sched_slice_bytes: int = -1
    # slab-pool admission high-water mark (a fraction of slab_pool_bytes):
    # background allocations (readahead buffers) wait while the pool sits
    # above it. 0 disables admission control
    sched_high_water: float = 0.9

    # the distributed data plane (strom_torch/dist): the peer extent
    # service. A context with peers attached (ctx.attach_peers) probes them
    # in the delivery consult after local RAM and spill and before the
    # engine: an extent hot on another host arrives over the socket
    # instead of a second SSD read. A failed fetch falls back to the local
    # engine, never fatal; a dead peer trips a per-peer circuit breaker
    dist_peer_timeout_s: float = 0.5   # a fetch's connect/recv timeout
    dist_server_max_conns: int = 8     # peer-server reads in flight
    # zero-copy serving: cache hits go to the socket straight from the
    # pinned views (MSG_ZEROCOPY where the kernel grants SO_ZEROCOPY),
    # spill hits through sendfile(2). Off = the copy path
    dist_send_zc: bool = False
    # peer-response compression: fetches name the probed codec and a
    # willing server answers compressed where that pays (raw otherwise); a
    # peer of the older wire is latched back to the plain ops. Off = the
    # plain wire, byte for byte
    peer_compress: bool = False
    # the batched transport packs up to this many extents into one
    # OP_GET_BATCH round trip (0 = one extent a round trip); the pool keeps
    # this many persistent connections a peer (overflow rides ephemeral
    # ones; a failed one is discarded)
    dist_batch_max_extents: int = 64
    dist_conn_pool_size: int = 2
    # shared-key auth: when non-empty every new peer connection passes an
    # HMAC-SHA256 challenge before its first request; a wrong or missing
    # key is refused (peer_auth_rejects). Empty = the open wire
    dist_auth_key: str = ""

    def __post_init__(self) -> None:
        if self.buffer_size == 0:
            object.__setattr__(self, "buffer_size", self.block_size)
        if self.block_size <= 0 or self.block_size % 512:
            raise ValueError(f"block_size must be a positive multiple of 512, "
                             f"got {self.block_size}")
        if self.buffer_size < self.block_size:
            raise ValueError("buffer_size must be >= block_size")
        if self.queue_depth <= 0:
            raise ValueError("queue_depth must be positive")
        if self.engine_rings < 1:
            raise ValueError("engine_rings must be >= 1")
        if self.ring_recovery_s < 0:
            raise ValueError("ring_recovery_s must be >= 0 (0 = sticky)")
        if self.num_buffers <= 0:
            raise ValueError("num_buffers must be positive")
        if self.engine not in ("auto", "uring", "python"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.overlap_chunk_bytes and self.overlap_chunk_bytes % 4096:
            raise ValueError("overlap_chunk_bytes must be a multiple of 4096 "
                             "(O_DIRECT alignment and dtype itemsize)")
        if self.coalesce_max_bytes < 0:
            raise ValueError("coalesce_max_bytes must be >= 0 (0 = off)")
        if self.engine_wait_timeout_s <= 0:
            raise ValueError("engine_wait_timeout_s must be positive")
        if self.io_retry_backoff_s < 0 or self.io_retry_backoff_max_s < 0:
            raise ValueError("io_retry_backoff(_max)_s must be >= 0")
        if self.io_retry_budget < 0:
            raise ValueError("io_retry_budget must be >= 0")
        if self.request_deadline_s < 0:
            raise ValueError("request_deadline_s must be >= 0 (0 = none)")
        if not 0.0 < self.breaker_error_rate <= 1.0:
            raise ValueError("breaker_error_rate must be in (0, 1]")
        if self.stripe_window_bytes < -1:
            raise ValueError("stripe_window_bytes must be >= 0 (0 = off) "
                             "or exactly -1 (auto)")
        if self.prefetch_max_depth < 1:
            raise ValueError("prefetch_max_depth must be >= 1")
        if self.metrics_port < 0 or self.metrics_port > 65535:
            raise ValueError("metrics_port must be in [0, 65535] (0 = off)")
        if self.tune_interval_s <= 0:
            raise ValueError("tune_interval_s must be > 0")
        if not 0.0 < self.tune_guard_frac <= 1.0:
            raise ValueError("tune_guard_frac must be in (0, 1]")
        if self.hot_cache_bytes < 0:
            raise ValueError("hot_cache_bytes must be >= 0 (0 = off)")
        if self.hot_cache_admit not in ("second_touch", "always"):
            raise ValueError("hot_cache_admit must be 'second_touch' or "
                             f"'always', got {self.hot_cache_admit!r}")
        if self.hot_cache_block_bytes <= 0 or self.hot_cache_block_bytes % 4096:
            raise ValueError("hot_cache_block_bytes must be a positive "
                             "multiple of 4096")
        if self.readahead_window_batches < 0:
            raise ValueError("readahead_window_batches must be >= 0 (0 = off)")
        if self.spill_bytes < 0:
            raise ValueError("spill_bytes must be >= 0 (0 = off)")
        if self.sched_slice_bytes < -1:
            raise ValueError("sched_slice_bytes must be >= 0 (0 = no "
                             "slicing) or exactly -1 (auto)")
        if not 0.0 <= self.sched_high_water <= 1.0:
            raise ValueError("sched_high_water must be in [0, 1] (0 = off)")
        if self.dist_peer_timeout_s <= 0:
            raise ValueError("dist_peer_timeout_s must be > 0")
        if self.dist_server_max_conns < 1:
            raise ValueError("dist_server_max_conns must be >= 1")
        if self.dist_batch_max_extents < 0:
            raise ValueError("dist_batch_max_extents must be >= 0 (0 = "
                             "unbatched)")
        if self.dist_conn_pool_size < 1:
            raise ValueError("dist_conn_pool_size must be >= 1")

    @property
    def resolved_stripe_window_bytes(self) -> int:
        """The effective striped-overlap window: -1 resolves to the engine's
        in-flight budget (queue_depth × block_size)."""
        if self.stripe_window_bytes >= 0:
            return self.stripe_window_bytes
        return self.queue_depth * self.block_size

    @classmethod
    def from_env(cls, **overrides: Any) -> "StromConfig":
        """Build a config from ``STROM_*`` env vars, explicit overrides
        winning."""
        kwargs: dict[str, Any] = {}
        for field in dataclasses.fields(cls):
            env_key = _ENV_PREFIX + field.name.upper()
            if env_key not in os.environ:
                continue
            raw = os.environ[env_key]
            if field.name == "o_direct" or field.type in ("bool", bool):
                kwargs[field.name] = _env_cast(raw, bool)
            elif field.type in ("int", int):
                kwargs[field.name] = _env_cast(raw, int)
            elif field.type in ("float", float):
                kwargs[field.name] = _env_cast(raw, float)
            else:
                kwargs[field.name] = raw
        kwargs.update(overrides)
        return cls(**kwargs)
