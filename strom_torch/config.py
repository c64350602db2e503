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
    engine: str = "python"             # only the preadv engine is ported
    io_retries: int = 1                # per-chunk resubmits before erroring

    # delivery
    prefetch_depth: int = 2            # batches dispatched ahead of consumption
    delivery_workers: int = 2          # threads running async transfers
    # merge caller fragments contiguous in both file and dest space into
    # fewer engine ops; merged ops split at this cap (0 = off)
    coalesce_max_bytes: int = 32 * MiB
    slab_pool_bytes: int = 512 * MiB   # recycled pinned host slabs (0 = off);
                                       # used only for CUDA targets
    # intra-transfer streaming: read piece k+1 from disk while piece k is
    # copied host->device, for transfers >= overlap_min_bytes (0 = off)
    overlap_chunk_bytes: int = 128 * MiB
    overlap_min_bytes: int = 256 * MiB

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
        if self.num_buffers <= 0:
            raise ValueError("num_buffers must be positive")
        if self.engine != "python":
            raise ValueError(f"the port has only the python engine, "
                             f"got {self.engine!r}")
        if self.overlap_chunk_bytes and self.overlap_chunk_bytes % 4096:
            raise ValueError("overlap_chunk_bytes must be a multiple of 4096 "
                             "(O_DIRECT alignment and dtype itemsize)")
        if self.coalesce_max_bytes < 0:
            raise ValueError("coalesce_max_bytes must be >= 0 (0 = off)")

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
            if field.name == "o_direct":
                kwargs[field.name] = _env_cast(raw, bool)
            elif field.type in ("int", int):
                kwargs[field.name] = _env_cast(raw, int)
            else:
                kwargs[field.name] = raw
        kwargs.update(overrides)
        return cls(**kwargs)
