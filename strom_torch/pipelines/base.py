"""Pipeline: a prefetched, checkpointable stream of device batches (the
port's counterpart of ``strom/pipelines/base.py``).

Ties together the sampler (which record indices), a batch builder (engine
read → host→device copy) and the Prefetcher. The sampler runs *ahead* of
consumption by the prefetch depth, so the saved state is derived from the
consumed count, never from the sampler's own cursor: a resume replays
nothing and skips nothing.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Callable, Iterator

import numpy as np

from strom_torch.delivery.prefetch import Prefetcher, bound_depth
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
                 scope: Any | None = None):
        """*depth* is the prefetch depth, the starting one when
        *auto_depth* moves it inside [1, *max_depth*]. *on_close* runs once
        the prefetcher has stopped (a readahead thread's or a decode pool's
        shutdown, say); *counters* adds the pipeline's own counts to
        :meth:`stats`. *scope*: the telemetry scope the pipeline counts
        its steps in (``pipeline_steps``), a label scope of the context's
        whose ``tenant`` label names the scheduler tenant its gathers take;
        None is the process-wide registry."""
        from strom_torch.utils.stats import global_stats

        self.scope = scope if scope is not None else global_stats
        self.sampler = sampler
        self.fingerprint = fingerprint or {}
        self._make_batch = make_batch
        self._depth_args = (depth, auto_depth, max_depth)
        self._executor = executor
        self._on_close = on_close
        self._counters = counters
        st = sampler.state
        self._consumed = st.epoch * sampler.batches_per_epoch + st.batch_in_epoch
        self._seed = st.seed
        self._prefetcher = self._start_stream()

    def _start_stream(self) -> Prefetcher:
        """Thunk generator + prefetcher from the sampler's CURRENT cursor."""
        sampler = self.sampler
        make_batch = self._make_batch
        start = self._consumed

        def thunks() -> Iterator[Callable[[], Any]]:
            # make_batch gets (indices, serial): serial is the global batch
            # number, stable across resume
            serial = start
            for indices in sampler:
                yield lambda idx=indices, s=serial: make_batch(idx, s)
                serial += 1

        depth, auto_depth, max_depth = self._depth_args
        return Prefetcher(thunks(), depth=depth, auto_depth=auto_depth,
                          max_depth=max_depth, executor=self._executor)

    def __iter__(self) -> "Pipeline":
        return self

    def __next__(self) -> Any:
        batch = next(self._prefetcher)
        self._consumed += 1
        self.scope.add("pipeline_steps")
        return batch

    # -- checkpoint/resume --------------------------------------------------
    def state(self) -> SamplerState:
        bpe = self.sampler.batches_per_epoch
        return SamplerState(epoch=self._consumed // bpe,
                            batch_in_epoch=self._consumed % bpe,
                            seed=self._seed)

    def save_state(self, path: str, extra: dict | None = None) -> None:
        save_loader_state(path, self.state(), self.fingerprint, extra)

    def restore(self, state: SamplerState) -> "Pipeline":
        """Rewind/fast-forward to *state*: the next delivered batch is the
        one an uninterrupted run would have delivered there. In-flight
        prefetched batches are discarded. Returns self."""
        if state.seed != self._seed:
            raise ValueError(
                f"state was captured with seed {state.seed} but this pipeline "
                f"shuffles with seed {self._seed}; refusing to resume a "
                "different batch order")
        target = state.epoch * self.sampler.batches_per_epoch \
            + state.batch_in_epoch
        if self._consumed == target:
            return self   # the in-flight window is already the right one
        self._prefetcher.close()
        self.sampler.state = SamplerState(epoch=state.epoch,
                                          batch_in_epoch=state.batch_in_epoch,
                                          seed=state.seed)
        self._consumed = target
        self._prefetcher = self._start_stream()
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
                  resume_from: "str | SamplerState | None",
                  ctx=None) -> tuple[SamplerState | None, dict]:
    """Fingerprint the shard list (striped aliases through *ctx*) and, when
    resuming, validate both the dataset identity and the shuffle seed.
    Accepts a loader-state path or a SamplerState."""
    fp = dataset_fingerprint(paths, ctx)
    if resume_from is None:
        return None, fp
    if isinstance(resume_from, SamplerState):
        state = resume_from
    else:
        state, _ = load_loader_state(resume_from, fp)
    if state.seed != seed:
        raise ValueError(
            f"loader state was saved with seed {state.seed} but the pipeline "
            f"was constructed with seed {seed}; refusing to resume a "
            "different shuffle order")
    return state, fp
