"""Engine selection, as the reference's: the C++ io_uring engine when the
kernel allows a ring, the preadv worker pool otherwise. The chosen engine
is named in ``stats()["engine"]``."""

from __future__ import annotations

from strom_torch.config import StromConfig
from strom_torch.engine.base import Completion, Engine, EngineError, ReadRequest  # noqa: F401


def make_engine(config: StromConfig | None = None) -> Engine:
    """``engine="auto"``: io_uring when ``uring_available()``, else python.
    ``"uring"``: io_uring or raise (EngineError when no ring can be made).
    ``engine_rings > 1`` gives a MultiRingEngine."""
    config = config or StromConfig.from_env()
    if config.engine in ("auto", "uring"):
        try:
            from strom_torch.engine.uring_engine import UringEngine, uring_available

            if config.engine == "uring" or uring_available():
                if config.engine_rings > 1:
                    from strom_torch.engine.multi import MultiRingEngine

                    return MultiRingEngine(config)
                return UringEngine(config)
        except Exception:
            if config.engine == "uring":
                raise
    from strom_torch.engine.python_engine import PythonEngine

    return PythonEngine(config)
