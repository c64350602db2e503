"""Joint checkpoints: the train state through the port's own ``ckpt`` (the
engine's write path), the loader's state beside it (the port's counterpart
of ``strom/pipelines/checkpoint.py``, which hands the state to orbax).

A resume restores both or neither: a train state without its loader
cursor replays data, a cursor without its state skips data. Both live in
one step directory, and the loader blob, written last, marks it complete.
"""

from __future__ import annotations

import copy
import logging
import os
import threading
from typing import Any

from strom_torch.ckpt.checkpoint import (_build_manifest, _commit_checkpoint,
                                         _host_leaves, restore_checkpoint)
from strom_torch.pipelines.base import Pipeline
from strom_torch.pipelines.sampler import (SamplerState, load_loader_state,
                                           save_loader_state)

_LOADER_FILE = "loader_state.json"
_STATE_DIR = "state"


class TrainCheckpointer:
    """Checkpoints of steps under ``root/<step>/``: the train state (a tree
    of tensors, e.g. ``parallel.train.train_state_tree(state)``) in
    ``state/`` through *ctx*'s engine, and the loader's blob."""

    def __init__(self, root: str, ctx):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._ctx = ctx
        self._pending: threading.Thread | None = None
        self._pending_error: BaseException | None = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"{step:08d}")

    def save(self, step: int, train_state: Any, pipeline: Pipeline,
             extra: dict | None = None, *, blocking: bool = True) -> str:
        """Save *train_state* and *pipeline*'s cursor as of this call.
        ``blocking=False`` returns once every leaf is a host copy the
        checkpointer owns and commits on a thread while training goes on;
        batches consumed meanwhile belong to the next checkpoint, and the
        loader blob is still written only after the state commits."""
        self._join_pending()
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        loader_state = pipeline.state()
        fingerprint = pipeline.fingerprint
        extra = copy.deepcopy(extra)   # the caller may change it meanwhile
        leaves, _ = _host_leaves(train_state, snapshot=not blocking,
                                 keep_device=blocking)
        manifest = _build_manifest(leaves)

        def commit_inner() -> None:
            _commit_checkpoint(self._ctx, os.path.join(d, _STATE_DIR),
                               leaves, manifest)
            save_loader_state(os.path.join(d, _LOADER_FILE), loader_state,
                              fingerprint, extra)

        if blocking:
            commit_inner()
            return d

        def commit() -> None:
            try:
                commit_inner()
            except BaseException as e:
                # kept for the next join, and logged now: a process that
                # never joins still leaves a trace of the lost checkpoint
                self._pending_error = e
                logging.getLogger("strom_torch.checkpoint").error(
                    "async checkpoint commit for %s failed: %r", d, e)

        # not a daemon: a normal exit waits for the last commit
        self._pending = threading.Thread(target=commit,
                                         name="strom-ckpt-commit")
        self._pending.start()
        return d

    def wait_until_finished(self) -> None:
        """Block until a non-blocking save has committed; raises its
        failure."""
        self._join_pending()

    def _join_pending(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        e, self._pending_error = self._pending_error, None
        if e is not None:
            raise RuntimeError("checkpoint commit failed") from e

    def latest_step(self) -> int | None:
        """The newest complete step (its loader blob, written last, is
        there)."""
        steps = []
        try:
            for name in os.listdir(self.root):
                if name.isdigit() and os.path.exists(
                        os.path.join(self.root, name, _LOADER_FILE)):
                    steps.append(int(name))
        except FileNotFoundError:
            return None
        return max(steps) if steps else None

    def loader_state_path(self, step: int) -> str:
        """The resume handle for ``make_*_pipeline(resume_from=...)``: the
        file, so the pipeline checks the dataset's fingerprint and seed."""
        return os.path.join(self._step_dir(step), _LOADER_FILE)

    def restore(self, step: int, template: Any
                ) -> tuple[Any, SamplerState, dict]:
        """(train state tree, loader sampler state, extra). The tree is
        shaped like *template* and lands on its leaves' devices; copy it
        into a live state with ``parallel.train.load_train_state``. To
        resume a pipeline prefer ``resume_from=self.loader_state_path(step)``
        (fingerprint-checked) over the returned SamplerState."""
        d = self._step_dir(step)
        state = restore_checkpoint(self._ctx, os.path.join(d, _STATE_DIR),
                                   template)
        sampler_state, extra = load_loader_state(
            os.path.join(d, _LOADER_FILE))
        return state, sampler_state, extra

    def close(self) -> None:
        self._join_pending()   # may raise a failed async commit
