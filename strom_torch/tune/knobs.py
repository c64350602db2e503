"""Knob surfaces the autotuner can move at runtime (the port's copy of
``strom/tune/knobs.py``).

A :class:`Knob` is a named scalar with live get/set accessors and bounds.
The tuner only moves values through ``set``; every surface here is one its
owner reads again at its next decision (the scheduler's slice per grant,
the cache budget per admit, the prefetch depth per fill), so a move takes
effect without a restart and a revert is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class Knob:
    """One tunable scalar: live accessors, bounds, and a search step.

    ``step`` is the tuner's initial move size; ``quantize`` snaps proposed
    values onto the surface's legal grid (int depths, 4 KiB-aligned byte
    budgets) so a knob can never be set to a value its owner would reject.
    """

    name: str
    get: Callable[[], float]
    set: Callable[[float], None]
    lo: float
    hi: float
    step: float
    quantize: Callable[[float], float] | None = None
    # smallest meaningful move — the tuner's step-halving floors here so
    # refinement can never shrink a proposal below the quantization grid
    # (where quantize would collapse it to a no-op and pin the knob)
    min_step: float | None = None

    @property
    def step_floor(self) -> float:
        return self.min_step if self.min_step is not None else self.step / 8

    def clamp(self, value: float) -> float:
        v = min(max(value, self.lo), self.hi)
        if self.quantize is not None:
            v = self.quantize(v)
        return min(max(v, self.lo), self.hi)


def _quant_int(v: float) -> float:
    return float(int(round(v)))


def _quant_4k(v: float) -> float:
    return float(max(int(v) // 4096, 1) * 4096)


def prefetcher_knob(pf, *, max_depth: int | None = None) -> Knob:
    """Depth knob over a live :class:`strom_torch.delivery.prefetch.Prefetcher`."""
    hi = float(max_depth if max_depth is not None
               else getattr(pf, "_max_depth", 16))
    return Knob(name="prefetch_depth",
                get=lambda: float(pf.depth),
                set=lambda v: pf.set_depth(int(v)),
                lo=float(getattr(pf, "_min_depth", 1)), hi=hi,
                step=1.0, quantize=_quant_int, min_step=1.0)


def standard_knobs(ctx) -> list[Knob]:
    """The knobs a :class:`StromContext` exposes, built from whichever
    surfaces this context actually has (scheduler off → no slice knob,
    cache off → no budget knob). Pipelines append their own (prefetch
    depth via :func:`prefetcher_knob`)."""
    knobs: list[Knob] = []
    sched = getattr(ctx, "scheduler", None)
    if sched is not None:
        base = float(sched._slice_bytes() or ctx.config.queue_depth
                     * ctx.config.block_size)

        def _set_slice(v: float, _s=sched) -> None:
            _s.slice_bytes_override = int(v)

        knobs.append(Knob(
            name="sched_slice_bytes",
            get=lambda _s=sched: float(_s._slice_bytes()),
            set=_set_slice,
            # an order of magnitude either side of the configured/auto
            # slice: enough room to matter, bounded so one runaway arm
            # can't turn slicing off entirely
            lo=max(base / 8, 256 * 1024.0), hi=base * 8,
            step=max(base / 4, 256 * 1024.0), quantize=_quant_4k,
            min_step=4096.0))
    cache = getattr(ctx, "hot_cache", None)
    if cache is not None:
        base = float(cache.max_bytes)

        def _set_budget(v: float, _c=cache) -> None:
            _c.max_bytes = int(v)

        knobs.append(Knob(
            name="cache_budget_bytes",
            get=lambda _c=cache: float(_c.max_bytes),
            set=_set_budget,
            # never below half the configured budget (shrinking a warm
            # cache evicts; the tuner explores, it must not thrash) and at
            # most 2x (host memory is someone else's budget too)
            lo=base / 2, hi=base * 2,
            step=base / 8, quantize=_quant_4k, min_step=4096.0))
    # pipeline surfaces registered via ctx.register_tunable: present only
    # after a pipeline is built on this context
    tunables = getattr(ctx, "_tunables", {})
    pool = tunables.get("decode_pool")
    if pool is not None and hasattr(pool, "run_target_us"):
        def _set_target(v: float, _p=pool) -> None:
            _p.run_target_us = float(v)

        knobs.append(Knob(
            name="decode_run_target_us",
            get=lambda _p=pool: float(_p.run_target_us),
            set=_set_target,
            # half a task-overhead-bound run up to 5x the measured sweet
            # spot: enough room to trade tail granularity vs dispatch
            # overhead, never so low that fusing degenerates to per-sample
            lo=500.0, hi=20000.0, step=1000.0, min_step=100.0))
    # the peer tier (StromContext.attach_peers registers it)
    tier = tunables.get("peer_tier")
    if tier is not None and hasattr(tier, "batch_max_extents"):
        def _set_batch(v: float, _t=tier) -> None:
            _t.batch_max_extents = int(v)

        knobs.append(Knob(
            name="dist_batch_max_extents",
            get=lambda _t=tier: float(_t.batch_max_extents),
            set=_set_batch,
            # 1 keeps the batched wire on (0 = unbatched is the A/B arm's
            # call, not the tuner's); 512 bounds the per-chunk frame the
            # server must buffer before its first response byte
            lo=1.0, hi=512.0, step=16.0, quantize=_quant_int,
            min_step=1.0))

        def _set_pool(v: float, _t=tier) -> None:
            _t.conn_pool_size = int(v)

        knobs.append(Knob(
            name="dist_conn_pool_size",
            get=lambda _t=tier: float(_t.conn_pool_size),
            set=_set_pool,
            # at least one pooled conn per peer; 16 bounds idle-socket FD
            # cost across a wide fleet
            lo=1.0, hi=16.0, step=1.0, quantize=_quant_int, min_step=1.0))
    ra = tunables.get("readahead")
    if ra is not None and getattr(ra, "window_batches", 0) > 0:
        base = float(ra.window_batches)

        def _set_window(v: float, _r=ra) -> None:
            _r.window_batches = int(v)

        knobs.append(Knob(
            name="readahead_window_batches",
            get=lambda _r=ra: float(_r.window_batches),
            set=_set_window,
            # 1 keeps the warmer alive (0 = off is the operator's call,
            # not the tuner's); 4x the configured window bounds the cache
            # churn one runaway arm can cause
            lo=1.0, hi=max(base * 4, 16.0),
            step=1.0, quantize=_quant_int, min_step=1.0))
    return knobs
