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

from strom_torch.delivery.prefetch import Prefetcher
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
                 fingerprint: dict | None = None,
                 executor: concurrent.futures.Executor | None = None):
        self.sampler = sampler
        self.fingerprint = fingerprint or {}
        self._make_batch = make_batch
        self._depth = depth
        self._executor = executor
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

        return Prefetcher(thunks(), depth=self._depth, executor=self._executor)

    def __iter__(self) -> "Pipeline":
        return self

    def __next__(self) -> Any:
        batch = next(self._prefetcher)
        self._consumed += 1
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

    def close(self) -> None:
        self._prefetcher.close()

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def resolve_state(paths: tuple[str, ...], *, seed: int,
                  resume_from: "str | SamplerState | None"
                  ) -> tuple[SamplerState | None, dict]:
    """Fingerprint the shard list and, when resuming, validate both the
    dataset identity and the shuffle seed. Accepts a loader-state path or a
    SamplerState."""
    fp = dataset_fingerprint(paths)
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
