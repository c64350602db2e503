"""strom_torch — the PyTorch / CUDA port of strom for an NVIDIA H100.

A package of its own beside ``strom`` (the JAX/TPU reference): it imports
``torch`` and never ``jax`` or ``strom``. API ≙ the reference's ioctl
contract:

=============================  ==========================================
reference (ioctl ABI)          strom_torch (this module)
=============================  ==========================================
STROM_IOCTL__CHECK_FILE        strom_torch.check_file(path | StripedFile)
STROM_IOCTL__MAP_GPU_MEMORY    strom_torch.init(config) / map_buffers()
STROM_IOCTL__LIST/INFO...      strom_torch.buffer_info()
STROM_IOCTL__MEMCPY_SSD2GPU    strom_torch.memcpy_ssd2gpu(..., async_=False)
  ..._ASYNC                    strom_torch.memcpy_ssd2gpu(..., async_=True)
STROM_IOCTL__MEMCPY_WAIT       strom_torch.memcpy_wait(handle)
/proc/nvme-strom               strom_torch.stats() / prometheus()
(in-kernel md-raid0 decode)    strom_torch.StripedFile / register_striped
=============================  ==========================================

``memcpy_ssd2host`` is the delivered path stopped before the copy to the
device. The workload pipelines (``make_llama_pipeline``; for ImageNet →
ResNet-50 ``make_imagenet_resnet_pipeline``, ``make_wds_vision_pipeline``
and ``make_predecoded_vision_pipeline``; for WebDataset → ViT-B/16
``make_vit_wds_pipeline``) take a context and yield batches as tensors on
one device.

Many cards run one process a card: ``init_distributed()`` joins the
process group, ``make_mesh`` lays the ranks out on named axes, and a
``TorchSharding(mesh, P("dp", None))`` given as ``sharding=`` to
``memcpy_ssd2gpu`` or ``make_llama_pipeline`` delivers each process only
its own block, as a global ``DTensor``.

Entry points target the current CUDA device unless the caller passes
``device="cpu"``; with no device given and no CUDA present they raise.
"""

from __future__ import annotations

from typing import Any

from strom_torch.config import StromConfig  # noqa: F401
from strom_torch.delivery.core import (Source, StripedFile,  # noqa: F401
                                       StromContext)
from strom_torch.delivery.extents import Extent, ExtentList  # noqa: F401
from strom_torch.delivery.handle import DMAHandle  # noqa: F401
from strom_torch.pipelines import (  # noqa: F401
    make_imagenet_resnet_pipeline, make_llama_pipeline,
    make_predecoded_vision_pipeline, make_vit_wds_pipeline,
    make_wds_vision_pipeline)
from strom_torch.parallel.mesh import (  # noqa: F401
    init_distributed, make_mesh, shutdown as shutdown_distributed)
from strom_torch.parallel.sharding import P, TorchSharding  # noqa: F401
from strom_torch.probe.check import FileReport, PathTier  # noqa: F401
from strom_torch.probe.check import check_file as _probe_check_file
from strom_torch.utils.locks import make_lock

__version__ = "0.1.0"

_ctx: StromContext | None = None
_ctx_lock = make_lock("app.ctx")


def check_file(path, **kwargs) -> FileReport:
    """≙ STROM_IOCTL__CHECK_FILE. Accepts a path or a StripedFile; a path
    the process context aliases to a striped set (``register_striped``) is
    checked as that set, without creating a context."""
    source = path
    with _ctx_lock:
        if _ctx is not None and isinstance(path, str):
            source = _ctx.resolve_source(path)
    return _probe_check_file(source, **kwargs)


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


def memcpy_ssd2host(source: Source, **kwargs: Any):
    """The delivered path stopped before the copy to the device: plan,
    route, gather into the final host array zero-copy. See
    StromContext.memcpy_ssd2host."""
    return context().memcpy_ssd2host(source, **kwargs)


def memcpy_wait(handle: DMAHandle, timeout: float | None = None):
    """Block until an async copy retires; returns the delivered tensor.
    ≙ STROM_IOCTL__MEMCPY_WAIT."""
    return handle.result(timeout)


def register_striped(path: str, members: "StripedFile | Any",
                     chunk: int | None = None,
                     size: int | None = None) -> StripedFile:
    """Alias *path* to a RAID0 striped set on the process-wide context: reads
    addressed to the path, extent lists planned against it included,
    stripe-decode across the members. See StromContext.register_striped."""
    return context().register_striped(path, members, chunk, size)


def buffer_info() -> dict:
    """The engine's staging pool: slots, slot size, bytes, engine."""
    return context().buffer_info()


def map_buffers() -> list:
    """Zero-copy numpy views of the engine's staging-pool slots
    (≙ MAP_GPU_MEMORY handing back the pinned window)."""
    ctx = context()
    return [ctx.engine.buffer(i) for i in range(ctx.engine.num_buffers)]


def stats() -> dict:
    """The process-wide context's nested stats sections (``context``,
    ``engine``, ``slab_pool``, ...), creating the context as the reference
    does."""
    global _ctx
    with _ctx_lock:
        if _ctx is None:
            _ctx = StromContext()
        return _ctx.stats()


def prometheus() -> str:
    """One scrape of the whole data path as Prometheus text: the
    process-wide registry (scopes as labelled samples) and, when the
    process context exists, its sections (≙ the reference's /proc node)."""
    from strom_torch.utils.stats import global_stats, sections_prometheus

    text = global_stats.prometheus()
    # inside the lock: a concurrent close() or init() must not tear the
    # engine down under the scrape
    with _ctx_lock:
        if _ctx is not None:
            text += sections_prometheus(_ctx.stats())
    return text


def close() -> None:
    global _ctx
    with _ctx_lock:
        if _ctx is not None:
            _ctx.close()
            _ctx = None
