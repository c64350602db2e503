"""Observability of the port: the event ring (:mod:`.events`) and causal
request tracing with deadlines (:mod:`.request`)."""

from strom_torch.obs.events import EventRing, ring  # noqa: F401
