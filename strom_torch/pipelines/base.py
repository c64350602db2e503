"""Pipeline: a prefetched, checkpointable stream of device batches (the
port's counterpart of ``strom/pipelines/base.py``).

Ties together the sampler (which record indices), a batch builder (engine
read → host→device copy) and the Prefetcher. The sampler runs *ahead* of
consumption by the prefetch depth, so the saved state is derived from the
consumed count, never from the sampler's own cursor: a resume replays
nothing and skips nothing. :meth:`Pipeline.token` captures that position
with the prefetch depth and the dataset's fingerprint as a StepToken, and
:meth:`Pipeline.restore` continues from one. Each ``__next__`` is a traced
``step`` request (``obs/request.py``) and a step of the pipeline's
:class:`~strom_torch.parallel.multihost.StragglerMonitor`; with
``epoch_sync`` every process meets at each epoch boundary.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable, Iterator

import numpy as np

from strom_torch.delivery.prefetch import Prefetcher, bound_depth
from strom_torch.obs import request as _request
from strom_torch.parallel.multihost import StragglerMonitor, epoch_barrier
from strom_torch.pipelines.sampler import (EpochShuffleSampler, SamplerState,
                                           dataset_fingerprint,
                                           load_loader_state,
                                           save_loader_state)


class Pipeline:
    """Iterate device batches; `state()` is always the resume point of the
    *next* unconsumed batch."""

    def __init__(self, sampler: EpochShuffleSampler,
                 make_batch: Callable[[np.ndarray, int], Any], *,
                 depth: int = 2,
                 auto_depth: bool = False,
                 max_depth: int | None = None,
                 fingerprint: dict | None = None,
                 executor: concurrent.futures.Executor | None = None,
                 on_close: Callable[[], None] | None = None,
                 counters: Callable[[], dict] | None = None,
                 epoch_sync: bool = False,
                 scope: Any | None = None,
                 req_owner: Any | None = None):
        """*depth* is the prefetch depth, the starting one when
        *auto_depth* moves it inside [1, *max_depth*]. *on_close* runs once
        the prefetcher has stopped (a readahead thread's or a decode pool's
        shutdown, say); *counters* adds the pipeline's own counts to
        :meth:`stats`. *scope*: the telemetry scope the pipeline counts
        its steps in (``pipeline_steps``), a label scope of the context's
        whose ``tenant`` label names the scheduler tenant its gathers take;
        None is the process-wide registry. The prefetcher mirrors its depth
        and stall gauges into it. *req_owner*: the owning context's request
        token (``ctx._req_owner``), carried by each ``step`` request, so
        that only that context's SLO engine takes them.

        *epoch_sync*: every process meets at a barrier before the first
        batch of each epoch after the first is dispatched, so that no
        process issues next-epoch reads while another still reads the
        previous epoch. The barrier sits where the prefetcher pulls that
        batch, not in ``__next__``: the sampler runs ahead of consumption
        by the prefetch depth. One gloo round trip an epoch; every
        process must build its pipeline with the same arguments."""
        from strom_torch.utils.stats import global_stats

        self.scope = scope if scope is not None else global_stats
        self.sampler = sampler
        self.fingerprint = fingerprint or {}
        self._make_batch = make_batch
        self._depth_args = (depth, auto_depth, max_depth)
        self._executor = executor
        self._on_close = on_close
        self._counters = counters
        self._req_owner = req_owner
        self._epoch_sync = epoch_sync
        self.monitor = StragglerMonitor()
        self._last_next: float | None = None
        st = sampler.state
        self._consumed = st.epoch * sampler.batches_per_epoch + st.batch_in_epoch
        self._seed = st.seed
        self._prefetcher = self._start_stream(depth)

    def _start_stream(self, depth: int) -> Prefetcher:
        """Thunk generator + prefetcher from the sampler's CURRENT cursor,
        starting at *depth*."""
        sampler = self.sampler
        make_batch = self._make_batch
        start = self._consumed
        bpe = sampler.batches_per_epoch

        def thunks() -> Iterator[Callable[[], Any]]:
            # make_batch gets (indices, serial): serial is the global batch
            # number, stable across resume
            serial = start
            for indices in sampler:
                if self._epoch_sync and serial % bpe == 0 and serial != start:
                    epoch_barrier(f"strom-epoch-{serial // bpe}")
                yield lambda idx=indices, s=serial: make_batch(idx, s)
                serial += 1

        _, auto_depth, max_depth = self._depth_args
        return Prefetcher(thunks(), depth=depth, auto_depth=auto_depth,
                          max_depth=max_depth, executor=self._executor,
                          scope=self.scope)

    def __iter__(self) -> "Pipeline":
        return self

    def __next__(self) -> Any:
        # the consumer's wait for a batch, as a "step" request of the
        # pipeline's tenant (the batch's own gathers are minted where they
        # run, on the prefetcher's threads)
        tname = getattr(self.scope, "labels", {}).get("tenant")
        with _request.active("step", tname, owner=self._req_owner), \
                _request.span("pipeline.next", cat="ingest_wait",
                              args={"step": self._consumed}):
            batch = next(self._prefetcher)
        self._consumed += 1
        self.scope.add("pipeline_steps")
        # the process's step cadence (consumer compute + any data wait):
        # the input of the cross-process straggler accounting
        now = time.monotonic()
        if self._last_next is not None:
            self.monitor.record(now - self._last_next)
        self._last_next = now
        return batch

    # -- checkpoint/resume --------------------------------------------------
    def state(self) -> SamplerState:
        bpe = self.sampler.batches_per_epoch
        return SamplerState(epoch=self._consumed // bpe,
                            batch_in_epoch=self._consumed % bpe,
                            seed=self._seed)

    def save_state(self, path: str, extra: dict | None = None) -> None:
        save_loader_state(path, self.state(), self.fingerprint, extra)

    def token(self, ctx: Any | None = None, *, warm_state: bool = False,
              extra: dict | None = None):
        """The :class:`~strom_torch.ckpt.jobstate.StepToken` of the next
        unconsumed batch: the sampler position derived from the consumed
        count (the no-replay, no-skip contract of :meth:`state`), the
        global serial, the prefetcher's current depth, the dataset's
        fingerprint and, with ``warm_state=True`` and a *ctx*, the cache
        and spill manifests as advisory rewarm hints."""
        # imported here: ckpt.jobstate imports this package's sampler
        from strom_torch.ckpt.jobstate import StepToken, capture_warm_state

        return StepToken(
            sampler=self.state(),
            consumed=self._consumed,
            prefetch_depth=self._prefetcher.depth,
            fingerprint=dict(self.fingerprint),
            warm=capture_warm_state(ctx) if (warm_state and ctx is not None)
            else None,
            extra=dict(extra or {}))

    def restore(self, token) -> "Pipeline":
        """Rewind/fast-forward to *token* (a StepToken or a SamplerState):
        the next delivered batch is the one an uninterrupted run would have
        delivered there. A token of another dataset (its fingerprint) or
        another shuffle seed raises ValueError. A pipeline already at the
        position keeps its prefetch window; otherwise the in-flight batches
        are discarded and the prefetcher restarts at the token's depth.
        Returns self."""
        from strom_torch.ckpt.jobstate import StepToken

        if isinstance(token, StepToken):
            st, depth = token.sampler, token.prefetch_depth
            if token.fingerprint and self.fingerprint \
                    and token.fingerprint != self.fingerprint:
                raise ValueError(
                    "StepToken was captured against a different dataset "
                    f"({len(token.fingerprint.get('paths', ()))} shards vs "
                    f"{len(self.fingerprint.get('paths', ()))}); refusing "
                    "to resume")
        else:
            st, depth = token, 0
        if st.seed != self._seed:
            raise ValueError(
                f"token was captured with seed {st.seed} but this pipeline "
                f"shuffles with seed {self._seed}; refusing to resume a "
                "different batch order")
        target = st.epoch * self.sampler.batches_per_epoch \
            + st.batch_in_epoch
        if self._consumed == target \
                and (depth <= 0 or depth == self._prefetcher.depth):
            return self   # the in-flight window is already the right one
        self._prefetcher.close()
        self.sampler.state = SamplerState(epoch=st.epoch,
                                          batch_in_epoch=st.batch_in_epoch,
                                          seed=st.seed)
        self._consumed = target
        self._prefetcher = self._start_stream(
            depth if depth > 0 else self._depth_args[0])
        return self

    # -- observability ------------------------------------------------------
    @property
    def data_stall_steps(self) -> int:
        return self._prefetcher.data_stall_steps

    @property
    def prefetch_depth(self) -> int:
        """Current prefetch depth (moves when auto_depth is on)."""
        return self._prefetcher.depth

    @property
    def prefetch_depth_trace(self) -> list[tuple[int, int]]:
        """(step, depth) at every controller move, starting depth included."""
        return list(self._prefetcher.depth_trace)

    def straggler_report(self, threshold: float = 1.25):
        """Cross-process step-time skew (a collective: every process must
        call)."""
        return self.monitor.report(threshold)

    def stats(self) -> dict:
        """``data_stall_steps``, the prefetcher's counters (``prefetch_*``)
        and the pipeline's own counters."""
        out = {"data_stall_steps": self.data_stall_steps}
        out.update({k if k.startswith("prefetch_") else f"prefetch_{k}": v
                    for k, v in self._prefetcher.snapshot().items()
                    if k != "data_stall_steps"})
        if self._counters is not None:
            out.update(self._counters())
        return out

    def close(self) -> None:
        self._prefetcher.close()
        if self._on_close is not None:
            on_close, self._on_close = self._on_close, None
            on_close()

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _auto_depth_bounds(ctx, auto_prefetch: bool | None,
                       batch_bytes: int) -> tuple[bool, int | None]:
    """(auto_depth, max_depth) for a pipeline: *auto_prefetch* None defers
    to ``ctx.config.prefetch_auto``; when auto, the ceiling is the config's
    prefetch_max_depth further bounded by what the slab pool can stage at
    *batch_bytes* per in-flight batch, less the hot cache's budget
    (:func:`strom_torch.delivery.prefetch.bound_depth`)."""
    cfg = ctx.config
    auto = cfg.prefetch_auto if auto_prefetch is None else auto_prefetch
    if not auto:
        return False, None
    return True, bound_depth(cfg.slab_pool_bytes, batch_bytes,
                             cap=cfg.prefetch_max_depth,
                             reserve_bytes=cfg.hot_cache_bytes)


def resolve_state(paths: tuple[str, ...], *, seed: int,
                  resume_from: "str | SamplerState | Any | None",
                  ctx=None) -> tuple[SamplerState | None, dict]:
    """Fingerprint the shard list (striped aliases through *ctx*) and, when
    resuming, validate both the dataset identity and the shuffle seed.
    Accepts a loader-state path, a SamplerState or a StepToken (its
    fingerprint checked against the live shard list). Only the position
    is taken from a token: adopt its prefetch depth and warm hints with
    ``Pipeline.restore(token)`` and ``restore_warm_state`` after
    construction."""
    from strom_torch.ckpt.jobstate import StepToken

    fp = dataset_fingerprint(paths, ctx)
    if resume_from is None:
        return None, fp
    if isinstance(resume_from, StepToken):
        if resume_from.fingerprint and resume_from.fingerprint != fp:
            raise ValueError(
                "StepToken was captured against a different dataset "
                f"(saved {len(resume_from.fingerprint.get('paths', ()))} "
                f"shards, now {len(fp['paths'])}); refusing to resume")
        state = resume_from.sampler
    elif isinstance(resume_from, SamplerState):
        state = resume_from
    else:
        state, _ = load_loader_state(resume_from, fp)
    if state.seed != seed:
        raise ValueError(
            f"loader state was saved with seed {state.seed} but the pipeline "
            f"was constructed with seed {seed}; refusing to resume a "
            "different shuffle order")
    return state, fp
