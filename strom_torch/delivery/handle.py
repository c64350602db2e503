"""Async DMA handles — the MEMCPY_WAIT side of the contract (the port's
copy of ``strom/delivery/handle.py``).

The handle wraps the whole pipeline (engine reads → pinned slab → the
host→device copy on the context's copy stream) and resolves to a
``torch.Tensor``. ``.result()`` returns once the copy is enqueued and the
stream that was current at the call is ordered after it;
``.block_until_ready()`` is the full barrier: it also waits on the copy
stream's event recorded after the tensor's last copy, so the tensor can
then be read from any stream with no further synchronisation.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable

from strom_torch.utils.locks import make_lock
from strom_torch.utils.stats import global_stats


class DMAHandle:
    """Future-like handle for an in-flight ssd2gpu copy. *ready*: a list
    the pipeline appends the copy stream's completion event to (a CUDA
    target; it stays empty for a CPU one) before the future resolves."""

    def __init__(self, future: concurrent.futures.Future, *, nbytes: int,
                 label: str = "", ready: list | None = None):
        self._future = future
        self.nbytes = nbytes
        self.label = label
        self._ready = ready if ready is not None else []
        self.submitted_at = time.monotonic()
        self._done_at: float | None = None
        self._lock = make_lock("app.handle")
        future.add_done_callback(self._on_done)

    def _on_done(self, _f) -> None:
        with self._lock:
            self._done_at = time.monotonic()
        global_stats.add("handles_completed")

    # -- MEMCPY_WAIT equivalents -------------------------------------------
    def done(self) -> bool:
        return self._future.done()

    def wait(self, timeout: float | None = None) -> "DMAHandle":
        """Block until the host-side pipeline retires. Raises the
        pipeline's error, if any."""
        self._future.result(timeout)
        return self

    def result(self, timeout: float | None = None) -> Any:
        """The delivered tensor."""
        return self._future.result(timeout)

    def exception(self, timeout: float | None = None):
        """The pipeline's error, None when it succeeded."""
        return self._future.exception(timeout)

    def block_until_ready(self, timeout: float | None = None) -> Any:
        """Full barrier: the delivered tensor once its device copy has
        completed (the copy stream's event, not a device-wide
        synchronize). Afterwards any stream may read it as it is."""
        value = self.result(timeout)
        for ev in self._ready:
            ev.synchronize()
        return value

    @property
    def elapsed_s(self) -> float:
        """Seconds from submission to the pipeline's end (so far, while it
        runs)."""
        end = self._done_at if self._done_at is not None else time.monotonic()
        return end - self.submitted_at

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"DMAHandle({self.label or hex(id(self))}, {self.nbytes}B, {state})"


def completed_handle(value: Any, nbytes: int = 0, label: str = "") -> DMAHandle:
    """A handle already resolved to *value*."""
    f: concurrent.futures.Future = concurrent.futures.Future()
    f.set_result(value)
    return DMAHandle(f, nbytes=nbytes, label=label)


def deferred_handle(fn: Callable[[], Any], executor: concurrent.futures.Executor,
                    nbytes: int, label: str = "",
                    ready: list | None = None) -> DMAHandle:
    return DMAHandle(executor.submit(fn), nbytes=nbytes, label=label,
                     ready=ready)
