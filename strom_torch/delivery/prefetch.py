"""Prefetch queue: keep N batches in flight so compute never waits on I/O
(the port's copy of the fixed-depth half of ``strom/delivery/prefetch.py``;
auto-depth is still to be ported).

The "0 data-stall steps" counter lives here: a stall is recorded whenever
``next()`` has to block because the head-of-line batch isn't ready.
"""

from __future__ import annotations

import concurrent.futures
import threading
from collections import deque
from typing import Callable, Generic, Iterable, Iterator, TypeVar

T = TypeVar("T")


class Prefetcher(Generic[T]):
    """Wraps an iterable of thunks (callables producing a batch) and runs up
    to *depth* of them ahead on an executor, yielding results in order.

    Thunks end in the host→device copy being enqueued, so "ready" means the
    host-side work is done and the copy is ordered before the consumer's
    next kernel."""

    def __init__(self, thunks: Iterable[Callable[[], T]], *, depth: int = 2,
                 executor: concurrent.futures.Executor | None = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._depth = depth
        self._thunks = iter(thunks)
        self._own_executor = executor is None
        self._executor = executor or concurrent.futures.ThreadPoolExecutor(
            max_workers=depth, thread_name_prefix="strom-prefetch")
        self._queue: deque[concurrent.futures.Future] = deque()
        self._lock = threading.Lock()
        self._exhausted = False
        self.data_stall_steps = 0
        self._fill()

    def _fill(self) -> None:
        # next(thunks) runs outside the lock: a thunk generator may block
        while True:
            with self._lock:
                if len(self._queue) >= self._depth or self._exhausted:
                    return
            try:
                thunk = next(self._thunks)
            except StopIteration:
                with self._lock:
                    self._exhausted = True
                return
            with self._lock:
                if self._exhausted:  # close() raced the pull: drop, don't submit
                    return
                self._queue.append(self._executor.submit(thunk))

    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        with self._lock:
            fut = self._queue.popleft() if self._queue else None
            exhausted = self._exhausted
        if fut is None:
            if exhausted:
                self._shutdown()
                raise StopIteration
            self._fill()
            with self._lock:
                if not self._queue:
                    self._shutdown()
                    raise StopIteration
                fut = self._queue.popleft()
        if not fut.done():
            self.data_stall_steps += 1
        result = fut.result()
        self._fill()
        return result

    def _shutdown(self) -> None:
        if self._own_executor:
            self._executor.shutdown(wait=False)

    def close(self) -> None:
        with self._lock:
            live = [f for f in self._queue if not f.cancel()]
            self._queue.clear()
            self._exhausted = True
        # a thunk already running keeps using the engine the pipeline tears
        # down after this returns: give it a bounded window to retire
        if live:
            concurrent.futures.wait(live, timeout=30.0)
        self._shutdown()
