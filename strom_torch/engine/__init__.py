"""Engine selection. The port has one engine so far, the preadv worker
pool; the io_uring engine is still to be ported."""

from __future__ import annotations

from strom_torch.config import StromConfig
from strom_torch.engine.base import Completion, Engine, EngineError, ReadRequest  # noqa: F401


def make_engine(config: StromConfig | None = None) -> Engine:
    from strom_torch.engine.python_engine import PythonEngine

    return PythonEngine(config or StromConfig.from_env())
