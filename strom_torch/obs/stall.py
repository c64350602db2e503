"""Per-step stall attribution (the port's copy of ``strom/obs/stall.py``):
where did each train step's wall time go?

The counters answer "how many stalls"; this answers "a stall on WHAT". From
the event ring's categorized spans, each step window (a ``cat="step"`` span,
or consecutive consumer ``cat="ingest_wait"`` spans when no explicit step
span exists) is split into buckets:

- ``ingest_wait`` — the consumer was blocked inside the pipeline's
  ``__next__`` (the union of ingest_wait spans intersected with the step
  window). This is wall time data delivery FAILED to hide.
- ``decode`` / ``put`` / ``read`` — how much of that wait the pipeline spent
  in JPEG decode workers, host->HBM dispatch, and engine gathers
  respectively (each category's span union intersected with the WAIT
  windows, not the whole step: work that overlapped compute was free and
  must not be billed).
- ``compute`` — the rest of the step: the consumer was doing its own work.

``goodput_pct`` = compute / wall over the window set — 100% is the "0
data-stall steps" north star restated as a fraction, and the per-bucket
p50/p99 say which subsystem to aim the next perf PR at.

Buckets can overlap each other (a wait can be simultaneously "decode" and
"read" when a gather feeds the decoder), so decode+put+read can exceed
ingest_wait; ingest_wait + compute always equals wall. All functions are
pure over event-dict lists (``EventRing.snapshot`` / ``chrome_trace
.load_events`` shapes) and unit-tested on synthetic timelines.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# the attribution vocabulary (strom/obs/events.py module docstring)
WAIT_CAT = "ingest_wait"
STEP_CAT = "step"
SUB_BUCKETS = ("decode", "put", "read")
BUCKETS = ("ingest_wait",) + SUB_BUCKETS + ("compute",)


@dataclasses.dataclass(frozen=True)
class StepBuckets:
    """One step's attribution, all microseconds."""

    ts_us: float
    wall_us: float
    ingest_wait_us: float
    decode_us: float
    put_us: float
    read_us: float

    @property
    def compute_us(self) -> float:
        return max(self.wall_us - self.ingest_wait_us, 0.0)


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted interval union."""
    if not iv:
        return []
    iv = sorted(iv)
    out = [iv[0]]
    for lo, hi in iv[1:]:
        if lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _clip(iv: list[tuple[float, float]], lo: float, hi: float
          ) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in iv
            if min(b, hi) > max(a, lo)]


def _total(iv: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in iv)


def _intersect(a: list[tuple[float, float]], b: list[tuple[float, float]]
               ) -> float:
    """Total overlap between two interval unions (both already merged)."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _spans_by_cat(events: Sequence[dict]) -> dict[str, list[tuple[float, float]]]:
    by_cat: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        by_cat.setdefault(cat, []).append(
            (e["ts_us"], e["ts_us"] + e.get("dur_us", 0.0)))
    return {c: _union(iv) for c, iv in by_cat.items()}


def _step_windows(events: Sequence[dict]) -> list[tuple[float, float]]:
    """The attribution windows: explicit step spans when present, else each
    consumer wait span start to the next (the flat-out-loader shape, where
    "compute" is whatever the consumer did between next() calls). The FINAL
    wait opens a window closed at the last event edge seen, so N next()
    calls yield N windows — a single-step trace is not silently empty."""
    steps = [(e["ts_us"], e["ts_us"] + e.get("dur_us", 0.0))
             for e in events
             if e.get("ph") == "X" and e.get("cat") == STEP_CAT]
    if steps:
        return sorted(steps)
    wait_ev = [e for e in events
               if e.get("ph") == "X" and e.get("cat") == WAIT_CAT]
    # prefer the consumer-level spans: a stalled next() nests a
    # prefetch.stall_wait span inside its pipeline.next span (same cat),
    # and counting BOTH starts would fabricate an extra step boundary
    # per stall. Unioning on top makes any remaining overlap harmless.
    nexts = [e for e in wait_ev if e.get("name") == "pipeline.next"]
    waits = _union([(e["ts_us"], e["ts_us"] + e.get("dur_us", 0.0))
                    for e in (nexts or wait_ev)])
    if not waits:
        return []
    out = [(waits[i][0], waits[i + 1][0]) for i in range(len(waits) - 1)]
    last_edge = max(e["ts_us"] + e.get("dur_us", 0.0) for e in events
                    if e.get("ph") == "X")
    out.append((waits[-1][0], max(waits[-1][1], last_edge)))
    return out


def step_buckets(events: Sequence[dict], lo_us: float | None = None,
                 hi_us: float | None = None) -> list[StepBuckets]:
    """Per-step bucket attribution for every step window inside
    [lo_us, hi_us] (defaults: everything)."""
    cats = _spans_by_cat(events)
    waits = cats.get(WAIT_CAT, [])
    out = []
    for w_lo, w_hi in _step_windows(events):
        if lo_us is not None and w_lo < lo_us:
            continue
        if hi_us is not None and w_hi > hi_us:
            continue
        step_waits = _clip(waits, w_lo, w_hi)
        sub = {}
        for cat in SUB_BUCKETS:
            sub[cat] = _intersect(cats.get(cat, []), step_waits)
        out.append(StepBuckets(
            ts_us=w_lo, wall_us=w_hi - w_lo,
            ingest_wait_us=_total(step_waits),
            decode_us=sub["decode"], put_us=sub["put"], read_us=sub["read"]))
    return out


def _pct(vals: list[float], q: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    k = min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))
    return vals[int(k)]


def steps_summary(events: Sequence[dict], lo_us: float | None = None,
                  hi_us: float | None = None) -> dict:
    """Aggregate per-step buckets into the report shape:
    ``{"steps_observed", "goodput_pct", "buckets": {name: {"total_us",
    "p50_us", "p99_us"}}}``."""
    steps = step_buckets(events, lo_us, hi_us)
    wall = sum(s.wall_us for s in steps)
    compute = sum(s.compute_us for s in steps)
    per_bucket: dict[str, dict] = {}
    for b in BUCKETS:
        vals = [getattr(s, f"{b}_us") for s in steps]
        per_bucket[b] = {"total_us": round(sum(vals), 1),
                         "p50_us": round(_pct(vals, 0.50), 1),
                         "p99_us": round(_pct(vals, 0.99), 1)}
    return {"steps_observed": len(steps),
            "goodput_pct": round(100.0 * compute / wall, 2) if wall else 0.0,
            "buckets": per_bucket}


def flatten_summary(summary: dict) -> dict:
    """``steps_summary`` -> flat numeric keys (the context's ``stats()``
    section ``steps``):
    ``goodput_pct``, ``steps_observed``, ``step_<bucket>_p50_us/_p99_us``."""
    out = {"goodput_pct": summary["goodput_pct"],
           "steps_observed": summary["steps_observed"]}
    for b, v in summary["buckets"].items():
        out[f"step_{b}_p50_us"] = v["p50_us"]
        out[f"step_{b}_p99_us"] = v["p99_us"]
    return out


# the flat stall columns (``StromContext.stats()["steps"]``), single-sourced
# so the context and the parity tests cannot drift apart
STALL_FIELDS = tuple(["goodput_pct", "steps_observed"]
                     + [f"step_{b}_{q}_us" for b in BUCKETS
                        for q in ("p50", "p99")])
