"""Device-to-SSD checkpoints through the engine's write path, async
snapshot-then-commit saves, and resume tokens (the port's copy of
``strom/ckpt``)."""

from strom_torch.ckpt.async_save import (CKPT_ASYNC_FIELDS, AsyncCheckpointer,
                                         CkptAsyncError, save_checkpoint_async)
from strom_torch.ckpt.checkpoint import (CKPT_FIELDS, CkptCorruptError,
                                         CkptError, clean_orphans,
                                         last_committed, load_manifest,
                                         load_pickle, restore_checkpoint,
                                         save_checkpoint, save_pickle)
from strom_torch.ckpt.jobstate import (RESUME_FIELDS, StepToken,
                                       capture_warm_state, restore_warm_state)

__all__ = [
    "CKPT_ASYNC_FIELDS",
    "CKPT_FIELDS",
    "RESUME_FIELDS",
    "AsyncCheckpointer",
    "CkptAsyncError",
    "CkptCorruptError",
    "CkptError",
    "StepToken",
    "capture_warm_state",
    "clean_orphans",
    "last_committed",
    "load_manifest",
    "load_pickle",
    "restore_checkpoint",
    "restore_warm_state",
    "save_checkpoint",
    "save_checkpoint_async",
    "save_pickle",
]
