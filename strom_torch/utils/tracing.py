"""Trace annotations (the port's copy of ``strom/utils/tracing.py``): ONE
span call feeds two emitters.

- the PyTorch profiler (``torch.profiler.record_function``), so I/O shows
  up inside a profiler session's trace beside the device kernels — the
  counterpart of the reference's ``jax.profiler.TraceAnnotation``;
- the event ring (:mod:`strom_torch.obs.events`), so the same span lands on
  the framework's own timeline (Chrome-trace export, stall attribution,
  flight bundles) even when no profiler session runs.

``cat`` is the stall-attribution category (``read`` / ``decode`` / ``put``
/ ``ingest_wait`` / ``step`` — see :mod:`strom_torch.obs.stall`); spans
without one still render on the timeline but join no bucket.
"""

from __future__ import annotations

import contextlib

from strom_torch.obs.events import ring


@contextlib.contextmanager
def trace_span(name: str, *, enabled: bool = True, cat: str = "",
               args: dict | None = None):
    """*enabled* gates the profiler annotation only (the
    ``trace_annotations`` config knob). The ring emission follows the
    ring's own switch, as every directly instrumented site does, so
    turning annotations off cannot zero ONE stall bucket while the others
    keep recording."""
    # unconditional: if the ring is enabled mid-span, the exit emission
    # must not fabricate a span stretching back to process start
    t0 = ring.now_us()
    try:
        if not enabled:
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            yield
    finally:
        if ring.enabled:
            # request-linked inside a traced request: the put spans riding
            # this helper join the batch's lane
            from strom_torch.obs import request as _request

            req = _request.current()
            if req is not None:
                req.record(name, cat, t0, ring.now_us() - t0, args,
                           parent=req.parent_of())
            else:
                ring.complete(t0, ring.now_us() - t0, cat, name, args)
