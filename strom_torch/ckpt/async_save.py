"""Snapshot-then-commit checkpoints (the port's copy of
``strom/ckpt/async_save.py``).

The blocking :func:`~strom_torch.ckpt.checkpoint.save_checkpoint` holds the
training thread for the whole save. This module splits the save where the
stall can end:

- **snapshot**, on the caller's thread: flatten the tree and copy every
  leaf to host memory the checkpointer owns (``_host_leaves(snapshot=
  True)``). Torch tensors are mutable, and a captured step rewrites its
  parameters, moments and lr in place at fixed addresses, so a save that
  kept references to device tensors would write a torn state once the
  next replay ran. The device leaves are copied into a pinned arena the
  checkpointer keeps from save to save, ordered after the work queued on
  the current stream and finished before :meth:`save` returns; from then
  on the caller may step freely.
- **commit**, on a writer thread: the same ``_commit_checkpoint`` the
  blocking save runs (double-buffered staging with the CRC in the copy
  pass, engine writes, fsync, the tmp-and-rename commit).

A failed commit never destroys the previous checkpoint (the rename is the
commit), latches the error and raises it, as :class:`CkptAsyncError`, from
the next :meth:`AsyncCheckpointer.save` or :meth:`AsyncCheckpointer.wait`.
One commit is in flight at a time: a second ``save`` first waits out the
current one (back-pressure, counted in its stall).

The reference also dumps a flight bundle on a failed commit and keeps its
counters in a stats registry; the port has neither yet and counts
``ckpt_async_*`` in ``ctx.stats()``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import os
import time
from typing import Any

import torch

from strom_torch.ckpt.checkpoint import (CkptError, _build_manifest,
                                         _commit_checkpoint, _host_leaves,
                                         _PinnedArena, load_manifest)
from strom_torch.utils.locks import make_lock

# the numbers an async-save measurement reports
CKPT_ASYNC_FIELDS = (
    "ckpt_async_saves",
    "ckpt_async_stall_p99_us",
    "ckpt_async_stall_mean_us",
    "ckpt_sync_save_wall_us",
    "ckpt_async_stall_frac",
    "ckpt_async_commit_mb_per_s",
)


class CkptAsyncError(CkptError):
    """A background commit failed; the previous checkpoint is intact and
    restorable. The failure is the ``__cause__``."""


class AsyncCheckpointer:
    """Snapshot-then-commit checkpoints to one directory, one writer per
    directory. ``save`` is the training loop's call, ``wait`` joins the
    commit in flight, ``last_committed`` is the committed directory (or
    None), ``close`` drains. ``stalls_us`` holds each save's time on the
    caller's thread (the last 1024)."""

    def __init__(self, ctx, directory: str):
        self._ctx = ctx
        self._dir = os.path.abspath(directory)
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="strom-ckpt-commit")
        self._lock = make_lock("app.ckpt_async")
        self._fut: "concurrent.futures.Future | None" = None
        self._error: "BaseException | None" = None
        self._last_manifest: "dict | None" = None
        self._closed = False
        # where the device leaves' snapshot lands: pinned, and reused by
        # every save (one commit in flight, joined before the next copy)
        self._arena = _PinnedArena() if torch.cuda.is_available() else None
        self.saves = 0
        self.commits = 0
        self.failures = 0
        self.stalls_us: "collections.deque[float]" = \
            collections.deque(maxlen=1024)

    def save(self, state: Any, *, extra: "dict | None" = None) -> int:
        """Snapshot *state* on this thread and hand the commit to the
        writer; returns the save's serial. Blocks for the snapshot (and a
        previous commit still running). Raises the latched
        :class:`CkptAsyncError` of a failed previous commit."""
        t0 = time.perf_counter()
        if self._closed:
            raise CkptError("AsyncCheckpointer is closed")
        self._join(raise_error=True)
        leaves, _ = _host_leaves(state, snapshot=True, arena=self._arena)
        manifest = _build_manifest(leaves, extra)
        with self._lock:
            self.saves += 1
            serial = self.saves
            self._fut = self._exec.submit(self._commit, leaves, manifest)
        self.stalls_us.append((time.perf_counter() - t0) * 1e6)
        self._ctx._count(ckpt_async_saves=1)
        return serial

    def _commit(self, leaves, manifest) -> dict:
        try:
            m = _commit_checkpoint(self._ctx, self._dir, leaves, manifest)
        except BaseException as e:
            with self._lock:
                self._error = e
                self.failures += 1
            self._ctx._count(ckpt_async_failures=1)
            self._dump_flight(e)
            raise
        with self._lock:
            self._last_manifest = m
            self.commits += 1
        self._ctx._count(ckpt_async_commits=1)
        return m

    def _dump_flight(self, exc: BaseException) -> None:
        """A failed commit is a post-mortem moment: a ``ckpt_commit_failed``
        bundle carries the stats, stacks and trace that led up to it (the
        context's recorder, or a one-shot capture into ``flight_dir``).
        Best effort: the error is latched either way."""
        with contextlib.suppress(Exception):
            fr = getattr(self._ctx, "flight_recorder", None)
            if fr is not None:
                fr.dump("ckpt_commit_failed", note=repr(exc))
            elif self._ctx.config.flight_dir:
                from strom_torch.obs.flight import dump_capture

                dump_capture(self._ctx.config.flight_dir,
                             reason="ckpt_commit_failed", note=repr(exc),
                             ctx=self._ctx)

    def _join(self, *, raise_error: bool) -> None:
        with self._lock:
            fut = self._fut
        if fut is not None:
            # the future's exception is raised through the latch below
            concurrent.futures.wait([fut])
            with self._lock:
                if self._fut is fut:
                    self._fut = None
        if raise_error:
            with self._lock:
                err, self._error = self._error, None
            if err is not None:
                raise CkptAsyncError(
                    f"async checkpoint commit to {self._dir} failed "
                    f"({err!r}); the previous checkpoint is intact"
                ) from err

    def wait(self) -> "dict | None":
        """Drain the commit in flight; raises the latched
        :class:`CkptAsyncError`. Returns the manifest of the newest
        committed save, None when nothing committed."""
        self._join(raise_error=True)
        with self._lock:
            return self._last_manifest

    def last_committed(self) -> "str | None":
        """The directory once a commit landed there (this checkpointer's
        or an earlier process's), else None. Never blocks."""
        with self._lock:
            if self._last_manifest is not None:
                return self._dir
        try:
            load_manifest(self._dir)
            return self._dir
        except CkptError:
            return None

    @property
    def in_flight(self) -> bool:
        with self._lock:
            return self._fut is not None and not self._fut.done()

    @property
    def error(self) -> "BaseException | None":
        """The latched commit failure (cleared when save or wait raises)."""
        with self._lock:
            return self._error

    def stats(self) -> dict:
        with self._lock:
            st = sorted(self.stalls_us)
            return {
                "ckpt_async_saves": self.saves,
                "ckpt_async_commits": self.commits,
                "ckpt_async_failures": self.failures,
                "ckpt_async_stall_p99_us":
                    round(st[min(int(len(st) * 0.99), len(st) - 1)], 1)
                    if st else 0.0,
                "ckpt_async_stall_mean_us":
                    round(sum(st) / len(st), 1) if st else 0.0,
            }

    def close(self, *, wait: bool = True) -> None:
        """Drain (``wait=True``) and stop the writer; a latched failure
        raises here unless ``wait=False``."""
        if self._closed:
            return
        self._closed = True
        try:
            if wait:
                self._join(raise_error=True)
        finally:
            self._exec.shutdown(wait=wait)
            if wait and self._arena is not None:
                # no commit reads it any more (without the wait one may:
                # the pages then stay locked until the process ends)
                self._arena.close()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        # an exception already unwinding is not masked by the drain's
        self.close(wait=exc_type is None)


def save_checkpoint_async(ctx, directory: str, state: Any, *,
                          extra: "dict | None" = None) -> AsyncCheckpointer:
    """Snapshot *state* now, commit in the background, return the
    checkpointer (``wait()`` gives the manifest). A loop that saves
    repeatedly holds one :class:`AsyncCheckpointer` instead."""
    cp = AsyncCheckpointer(ctx, directory)
    cp.save(state, extra=extra)
    return cp
