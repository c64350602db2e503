"""Llama packed-token pretrain loader (the port's counterpart of
``strom/pipelines/llama_pretrain.py``).

Token records go NVMe → pinned host slab (an O_DIRECT gather over the
batch's record extents) → one host→device copy per batch: no decode step,
no Python touching bulk bytes.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from strom_torch.delivery.core import StromContext, resolve_device
from strom_torch.formats.rawbin import TokenShardSet
from strom_torch.pipelines.base import Pipeline, resolve_state
from strom_torch.pipelines.sampler import EpochShuffleSampler, SamplerState


def make_llama_pipeline(ctx: StromContext, paths: Sequence[str], *,
                        batch: int, seq_len: int,
                        device: Any = None,
                        dtype: Any = np.int32,
                        seed: int = 0,
                        shuffle: bool = True,
                        prefetch_depth: int | None = None,
                        resume_from: "str | SamplerState | None" = None
                        ) -> Pipeline:
    """Infinite stream of token batches [batch, seq_len+1] (inputs+targets
    window) as torch tensors on *device* (None → the current CUDA device;
    raises without one). *resume_from* accepts a loader-state path or a
    SamplerState; a live pipeline also restores in place with
    ``Pipeline.restore(state)``."""
    device = resolve_device(device)
    shards = TokenShardSet(tuple(paths), record_tokens=seq_len + 1,
                           dtype=np.dtype(dtype))
    state, fp = resolve_state(shards.paths, seed=seed, resume_from=resume_from)
    sampler = EpochShuffleSampler(shards.num_records, batch, seed=seed,
                                  shuffle=shuffle, state=state)
    shape = (batch, seq_len + 1)

    def make_batch(indices: np.ndarray, serial: int) -> torch.Tensor:
        return ctx.memcpy_ssd2gpu(shards.extents(indices), shape=shape,
                                  dtype=shards.dtype, device=device)

    depth = prefetch_depth if prefetch_depth is not None \
        else ctx.config.prefetch_depth
    return Pipeline(sampler, make_batch, depth=depth, fingerprint=fp)
