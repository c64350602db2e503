"""Async DMA handles — the MEMCPY_WAIT side of the contract (the port's
copy of ``strom/delivery/handle.py``).

The handle wraps the whole pipeline (engine reads → pinned slab → the
host→device copy on the context's copy stream) and resolves to a
``torch.Tensor``. ``.result()`` returns once the copy is enqueued and the
stream that was current at the call is ordered after it.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Callable


class DMAHandle:
    """Future-like handle for an in-flight ssd2gpu copy."""

    def __init__(self, future: concurrent.futures.Future, *, nbytes: int,
                 label: str = ""):
        self._future = future
        self.nbytes = nbytes
        self.label = label

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

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"DMAHandle({self.label or hex(id(self))}, {self.nbytes}B, {state})"


def deferred_handle(fn: Callable[[], Any], executor: concurrent.futures.Executor,
                    nbytes: int, label: str = "") -> DMAHandle:
    return DMAHandle(executor.submit(fn), nbytes=nbytes, label=label)
