"""Observability of the port (its copy of ``strom/obs/``): the event ring
and causal request tracing with deadlines, and the ring's readers.

- :mod:`.events` — the bounded, thread-safe event ring every instrumented
  path records spans and instants into.
- :mod:`.request` — causal request tracing: a request id per gather or
  batch, propagated queue → grant → engine slice → put as parent-linked
  spans, with the request's deadline.
- :mod:`.chrome_trace` — the ring as Trace Event Format JSON (Perfetto /
  chrome://tracing), and host traces merged onto one clock.
- :mod:`.exemplars` — tail-based sampling: whole span trees kept only for
  slow, throttled or errored requests.
- :mod:`.stall` — per-step stall attribution into ingest_wait / decode /
  put / read / compute, and ``goodput_pct``.
- :mod:`.flight` — the flight recorder: a watchdog and atomic crash
  bundles.
- :mod:`.slo` — per-tenant SLO targets and multi-window burn rates.
- :mod:`.history` — a bounded ring of periodic registry snapshots, with
  rates.
- :mod:`.server` — the live endpoint: /metrics, /stats, /trace, /slo,
  /tune, /history, /tenants, /flight, /cluster.
- :mod:`.federation` — many processes' endpoints merged into one view,
  with a health watchdog.
"""

from strom_torch.obs.events import EventRing, ring  # noqa: F401
