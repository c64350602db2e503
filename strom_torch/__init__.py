"""strom_torch — the PyTorch / CUDA port of strom for an NVIDIA H100.

A package of its own beside ``strom`` (the JAX/TPU reference): it imports
``torch`` and never ``jax`` or ``strom``. API ≙ the reference's ioctl
contract:

=============================  ==========================================
reference (ioctl ABI)          strom_torch (this module)
=============================  ==========================================
STROM_IOCTL__MAP_GPU_MEMORY    strom_torch.init(config)
STROM_IOCTL__MEMCPY_SSD2GPU    strom_torch.memcpy_ssd2gpu(..., async_=False)
  ..._ASYNC                    strom_torch.memcpy_ssd2gpu(..., async_=True)
STROM_IOCTL__MEMCPY_WAIT       strom_torch.memcpy_wait(handle)
/proc/nvme-strom               strom_torch.stats()
=============================  ==========================================

Entry points target the current CUDA device unless the caller passes
``device="cpu"``; with no device given and no CUDA present they raise.
"""

from __future__ import annotations

import threading
from typing import Any

from strom_torch.config import StromConfig  # noqa: F401
from strom_torch.delivery.core import Source, StromContext  # noqa: F401
from strom_torch.delivery.extents import Extent, ExtentList  # noqa: F401
from strom_torch.delivery.handle import DMAHandle  # noqa: F401

__version__ = "0.1.0"

_ctx: StromContext | None = None
_ctx_lock = threading.Lock()


def init(config: StromConfig | None = None) -> StromContext:
    """Initialise (or re-initialise) the process-wide context: starts the
    engine; the pinned slab pool fills on first use. ≙ MAP_GPU_MEMORY."""
    global _ctx
    with _ctx_lock:
        if _ctx is not None:
            _ctx.close()
        _ctx = StromContext(config)
        return _ctx


def context() -> StromContext:
    global _ctx
    with _ctx_lock:
        if _ctx is None:
            _ctx = StromContext()
        return _ctx


def memcpy_ssd2gpu(source: Source, **kwargs: Any):
    """Read a byte range / array from NVMe and deliver it to the GPU. See
    StromContext.memcpy_ssd2gpu for arguments."""
    return context().memcpy_ssd2gpu(source, **kwargs)


def memcpy_wait(handle: DMAHandle, timeout: float | None = None):
    """Block until an async copy retires; returns the delivered tensor.
    ≙ STROM_IOCTL__MEMCPY_WAIT."""
    return handle.result(timeout)


def stats() -> dict:
    """Plain counters of the process-wide context (bytes, transfers, engine
    and slab-pool counters)."""
    with _ctx_lock:
        return _ctx.stats() if _ctx is not None else {}


def close() -> None:
    global _ctx
    with _ctx_lock:
        if _ctx is not None:
            _ctx.close()
            _ctx = None
