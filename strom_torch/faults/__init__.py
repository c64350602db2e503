"""Deterministic fault injection (the port's copy of ``strom/faults``).

A seeded, rule-based :class:`FaultPlan` decides, reproducibly, which
engine ops fail and how (errno, short read, bit flip, latency, stuck
completion, engine death), and :class:`FaultyEngine` applies those
decisions to any wrapped engine. ``StromConfig.fault_plan`` wires it into
a context, so any run goes under deterministic chaos; the resilience
layer (engine retries with backoff, the circuit breaker and its failover)
is tested against these plans. :func:`run_kill_resume` is the
kill-and-restart harness.
"""

from strom_torch.faults.plan import Fault, FaultPlan, FaultRule
from strom_torch.faults.proxy import FaultyEngine

__all__ = ["Fault", "FaultPlan", "FaultRule", "FaultyEngine",
           "run_kill_resume"]


def run_kill_resume(*args, **kwargs):
    """The kill/restart harness (:mod:`.resume_harness`), imported on
    first call: it pulls in the checkpoint and pipeline stack, which a
    context wrapping its engine in FaultyEngine must not pay for."""
    from strom_torch.faults.resume_harness import run_kill_resume as _run

    return _run(*args, **kwargs)
