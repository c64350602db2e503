"""StepToken: where a training job resumes (the port's copy of
``strom/ckpt/jobstate.py``).

The sampler makes the batch stream a pure function of (seed, epoch,
cursor), so a resume point is a handful of numbers:

- **position**: the loader's SamplerState of the next unconsumed batch,
  and the global consumed-batch serial, carried so a resumed process can
  check it continued at exactly the right batch;
- **prefetch depth**: the auto-depth controller's operating point, so a
  resumed job starts where the workload had converged;
- **warm-state hints** (optional): the hot cache's and the spill tier's
  resident ``(path, lo, hi)`` ranges at save time, which :func:`restore_warm_state` replays
  through ``ctx.warm``. Advisory: correctness never depends on them.

A token commits with the checkpoint it describes: the manifest's
``extra`` carries ``{"step_token": ...}``, so one rename makes both
durable.

:func:`set_resume_gauges` sets the verdict's numbers as gauges of the
stats registry, through a context's scope when it is given one.
"""

from __future__ import annotations

import dataclasses
import json
import os

from strom_torch.delivery.shard import Segment
from strom_torch.pipelines.sampler import SamplerState

TOKEN_VERSION = 1
TOKEN_KEY = "step_token"       # where a token rides in manifest["extra"]

# the verdict of a kill-and-restart run
RESUME_FIELDS = (
    "resume_ok",
    "resume_kill_step",
    "resume_restart_step",
    "resume_replayed_batches",
    "resume_batches_checked",
    "resume_orphan_tmps",
    "resume_ckpt_commits",
    "resume_wall_s",
)


@dataclasses.dataclass
class StepToken:
    """What a restarted job needs to continue the exact batch stream.
    ``sampler`` is the resume point of the next unconsumed batch
    (``Pipeline.state()``), ``consumed`` its global serial."""

    sampler: SamplerState
    consumed: int = 0
    prefetch_depth: int = 0            # 0: unknown, or a fixed depth
    fingerprint: dict = dataclasses.field(default_factory=dict)
    warm: "dict | None" = None         # restore_warm_state hints
    extra: dict = dataclasses.field(default_factory=dict)
    version: int = TOKEN_VERSION

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["sampler"] = self.sampler.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StepToken":
        if d.get("version") != TOKEN_VERSION:
            raise ValueError(f"unknown StepToken version {d.get('version')}")
        return cls(sampler=SamplerState.from_dict(d["sampler"]),
                   consumed=int(d.get("consumed", 0)),
                   prefetch_depth=int(d.get("prefetch_depth", 0)),
                   fingerprint=d.get("fingerprint") or {},
                   warm=d.get("warm"),
                   extra=d.get("extra") or {})

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "StepToken":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_manifest(cls, manifest: dict) -> "StepToken | None":
        """The token committed with a checkpoint, None where the save
        carried none."""
        doc = (manifest.get("extra") or {}).get(TOKEN_KEY)
        return cls.from_dict(doc) if doc else None


def capture_warm_state(ctx, *, max_entries: int = 4096) -> "dict | None":
    """The hot cache's and the spill tier's resident ranges as JSON-stable
    hints, ``{"cache": [[path, lo, hi], ...], "spill": [...]}``, newest
    first and at most *max_entries* a tier; None without a cache.
    Decoded-frame keys are skipped: their bytes are decode output, not
    ranges of a source."""
    cache = ctx.hot_cache
    if cache is None:
        return None
    out: dict = {"cache": cache.manifest(max_entries=max_entries)}
    spill = ctx.spill_tier
    if spill is not None:
        out["spill"] = spill.manifest(max_entries=max_entries)
    return out


def restore_warm_state(ctx, warm: "dict | None") -> int:
    """Replay warm hints through ``ctx.warm`` (yields to demand reads).
    Advisory: a vanished source is skipped and 0 is a legal answer.
    Returns bytes warmed."""
    if not warm or ctx.hot_cache is None:
        return 0
    by_path: dict[str, list[tuple[int, int]]] = {}
    for tier in ("cache", "spill"):
        for ent in warm.get(tier) or ():
            path, lo, hi = ent[0], int(ent[1]), int(ent[2])
            if isinstance(path, str) and hi > lo:
                by_path.setdefault(path, []).append((lo, hi))
    warmed = 0
    for path, spans in by_path.items():
        if not (os.path.exists(path)
                or ctx.striped_source(path) is not None):
            continue
        # overlapping ranges warm once
        spans.sort()
        merged: list[tuple[int, int]] = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        # one warm call a path, the ranges packed in its buffer
        segs = []
        dest = 0
        for lo, hi in merged:
            segs.append(Segment(lo, dest, hi - lo))
            dest += hi - lo
        warmed += ctx.warm(path, segs)
    return warmed


def set_resume_gauges(results: dict, scope=None) -> None:
    """Every numeric RESUME_FIELDS value of a verdict (a bool as 0 or 1)
    set as a same-named gauge of *scope* (a context's ``ctx.scope``; None
    is the process-wide registry): the live-scrape twin of the verdict."""
    if scope is None:
        from strom_torch.utils.stats import global_stats as scope

    for k in RESUME_FIELDS:
        v = results.get(k)
        if isinstance(v, bool):
            scope.set_gauge(k, int(v))
        elif isinstance(v, (int, float)):
            scope.set_gauge(k, v)
