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

from strom_torch.delivery.core import StromContext, resolve_device, source_size
from strom_torch.formats.rawbin import TokenShardSet
from strom_torch.pipelines.base import (Pipeline, _auto_depth_bounds,
                                        resolve_state)
from strom_torch.pipelines.sampler import EpochShuffleSampler, SamplerState


def make_llama_pipeline(ctx: StromContext, paths: Sequence[str], *,
                        batch: int, seq_len: int,
                        device: Any = None,
                        dtype: Any = np.int32,
                        seed: int = 0,
                        shuffle: bool = True,
                        prefetch_depth: int | None = None,
                        auto_prefetch: bool | None = None,
                        resume_from: "str | SamplerState | None" = None,
                        scope: dict | None = None
                        ) -> Pipeline:
    """Infinite stream of token batches [batch, seq_len+1] (inputs+targets
    window) as torch tensors on *device* (None → the current CUDA device;
    raises without one). *auto_prefetch* (None: the config's
    ``prefetch_auto``) lets the prefetch depth move from *prefetch_depth*
    on stalls and ample lead. *resume_from* accepts a loader-state path or a
    SamplerState; a live pipeline also restores in place with
    ``Pipeline.restore(state)``.

    *scope*: labels of the pipeline's telemetry scope over the context's
    (default ``{"pipeline": "llama"}``); a ``"tenant"`` label names the
    scheduler tenant every batch gather takes."""
    device = resolve_device(device)
    # sizes through the context, so striped-set aliases (paths that need
    # not exist on disk) work like files
    shards = TokenShardSet(
        tuple(paths), record_tokens=seq_len + 1, dtype=np.dtype(dtype),
        shard_sizes=tuple(source_size(ctx.resolve_source(p)) for p in paths))
    state, fp = resolve_state(shards.paths, seed=seed, resume_from=resume_from,
                              ctx=ctx)
    sampler = EpochShuffleSampler(shards.num_records, batch, seed=seed,
                                  shuffle=shuffle, state=state)
    pscope = ctx.scope.scoped(**(scope if scope is not None
                                 else {"pipeline": "llama"}))
    tname = getattr(pscope, "labels", {}).get("tenant")
    shape = (batch, seq_len + 1)

    def make_batch(indices: np.ndarray, serial: int) -> torch.Tensor:
        return ctx.memcpy_ssd2gpu(shards.extents(indices), shape=shape,
                                  dtype=shards.dtype, device=device,
                                  tenant=tname)

    depth = prefetch_depth if prefetch_depth is not None \
        else ctx.config.prefetch_depth
    auto, max_depth = _auto_depth_bounds(
        ctx, auto_prefetch, batch * (seq_len + 1) * np.dtype(dtype).itemsize)
    return Pipeline(sampler, make_batch, depth=depth, auto_depth=auto,
                    max_depth=max_depth, fingerprint=fp, scope=pscope)
