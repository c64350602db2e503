"""Trace Event Format export (the port's copy of
``strom/obs/chrome_trace.py``): the ring as a Perfetto/chrome://tracing
file.

The JSON object format (https://docs.google.com/document/d/1CvAClvFfyA5R-
PhYUmn5OOQtYMH4h6I0nSsKchNAySU) — ``{"traceEvents": [...]}`` with complete
('X') and instant ('i') events — loads directly in chrome://tracing and
https://ui.perfetto.dev. One row per thread: the engine reader, decode
workers, the prefetch pool and the consumer each get their own swimlane, so
"what was the step waiting on" is visible as literal white space on the
consumer row above busy worker rows.
"""

from __future__ import annotations

import json
import os

from strom_torch.obs.events import EventRing, ring as _global_ring


def to_trace_events(events: list[dict], *, pid: int | None = None
                    ) -> list[dict]:
    """Internal event dicts (see ``EventRing.snapshot``) -> Trace Event
    Format dicts. Pure (unit-testable); timestamps pass through unchanged
    (already microseconds, the TEF unit)."""
    pid = os.getpid() if pid is None else pid
    out = []
    for e in events:
        te = {"name": e["name"], "ph": e["ph"], "ts": e["ts_us"],
              "pid": pid, "tid": e["tid"], "cat": e.get("cat") or "strom"}
        if e["ph"] == "X":
            te["dur"] = e.get("dur_us", 0.0)
        elif e["ph"] in ("s", "t", "f"):
            # flow events: id connects the chain; bind to the ENCLOSING
            # slice at this timestamp so the arrow lands on the request's
            # span rather than a bare track position
            te["id"] = e.get("id", 0)
            if e["ph"] != "s":
                te["bp"] = "e"
        else:
            te["s"] = "t"  # instant scope: thread
        if e.get("args"):
            te["args"] = e["args"]
        out.append(te)
    return out


def trace_document(events: list[dict], *, meta: dict | None = None) -> dict:
    doc: dict = {"traceEvents": to_trace_events(events),
                 "displayTimeUnit": "ms"}
    if meta:
        doc["otherData"] = meta
    return doc


def dump(path: str, *, ring: EventRing | None = None,
         events: list[dict] | None = None, meta: dict | None = None) -> str:
    """Write the ring (default: the global one) as a Trace Event JSON file;
    returns *path*. ``events`` overrides the ring for pre-filtered dumps."""
    if events is None:
        events = (ring or _global_ring).snapshot()
    with open(path, "w") as f:
        json.dump(trace_document(events, meta=meta), f)
    return path


def _clock_shifts(host_events: "dict[str, list[dict]]") -> dict[str, float]:
    """Per-host timebase shift (microseconds to ADD to that host's
    timestamps) aligning every trace to the first host's clock. Each ring
    counts microseconds since its own creation, so raw cross-host offsets
    are arbitrary; the estimates come from the traces themselves — every
    traced peer exchange leaves a ``peer.clock_offset`` instant (NTP-style
    four-timestamp math over the RTT, left by a peer fabric) naming the
    peer's address, and each PeerServer stamps its own address as a
    ``peer.self`` instant. BFS over that offset graph; a host no exchange
    reached keeps shift 0 (its own timebase — visible, not wrong)."""
    self_addr: dict[str, str] = {}
    offsets: dict[tuple[str, str], float] = {}  # last estimate wins (EWMA)
    for host, evs in host_events.items():
        for e in evs:
            a = e.get("args") or {}
            if e.get("name") == "peer.self" and a.get("addr"):
                self_addr.setdefault(host, str(a["addr"]))
            elif e.get("name") == "peer.clock_offset" and "peer" in a:
                offsets[(host, str(a["peer"]))] = float(
                    a.get("offset_us", 0.0))
    addr_host = {addr: h for h, addr in self_addr.items()}
    adj: dict[str, list[tuple[str, float]]] = {h: [] for h in host_events}
    for (h, paddr), off in offsets.items():
        other = addr_host.get(paddr)
        if other is not None and other != h:
            # off = other's clock minus h's clock at one instant
            adj[h].append((other, off))
            adj[other].append((h, -off))
    shifts: dict[str, float] = {}
    for root in host_events:
        if root in shifts:
            continue
        shifts[root] = 0.0
        queue = [root]
        while queue:
            h = queue.pop(0)
            for other, off in adj.get(h, ()):
                if other not in shifts:
                    # t_global = t_h + shift[h] and t_h = t_other - off
                    shifts[other] = shifts[h] - off
                    queue.append(other)
    return shifts


def merge_host_traces(host_events: "dict[str, list[dict]]",
                      *, meta: dict | None = None) -> dict:
    """Merge N per-host event lists (``load_events`` shape, keyed by host
    id) into ONE Perfetto document: each host becomes a process row (a
    ``process_name`` metadata event names it), timestamps are shifted onto
    the first host's timebase via :func:`_clock_shifts`, and the cross-host
    ``reqx`` flow events — same flow id on the asking and serving host —
    render as arrows crossing the process rows."""
    shifts = _clock_shifts(host_events)
    tes: list[dict] = []
    for pid, (host, evs) in enumerate(host_events.items()):
        shift = shifts.get(host, 0.0)
        tes.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": f"host {host}"}})
        shifted = [{**e, "ts_us": e["ts_us"] + shift} for e in evs]
        tes.extend(to_trace_events(shifted, pid=pid))
    doc: dict = {"traceEvents": tes, "displayTimeUnit": "ms"}
    other = {"clock_shifts_us": {h: round(s, 1)
                                 for h, s in shifts.items()}}
    if meta:
        other.update(meta)
    doc["otherData"] = other
    return doc


def load_events(path: str) -> list[dict]:
    """Inverse of :func:`dump` for tools: a Trace Event JSON back into the
    internal event-dict shape ``strom_torch.obs.stall`` consumes. Tolerates plain
    event-array files too."""
    with open(path) as f:
        doc = json.load(f)
    tes = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    for te in tes:
        if te.get("ph") not in ("X", "i", "s", "t", "f"):
            continue
        e = {"ts_us": float(te.get("ts", 0.0)), "tid": te.get("tid", 0),
             "cat": te.get("cat", ""), "name": te.get("name", ""),
             "ph": te["ph"]}
        if te["ph"] == "X":
            e["dur_us"] = float(te.get("dur", 0.0))
        if te["ph"] in ("s", "t", "f"):
            e["id"] = te.get("id", 0)
        if te.get("args"):
            e["args"] = te["args"]
        out.append(e)
    out.sort(key=lambda e: e["ts_us"])
    return out
