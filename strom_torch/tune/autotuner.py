"""The closed-loop controller: coordinate descent with a guarded revert
(the port's copy of ``strom/tune/autotuner.py``).

An :class:`Autotuner` owns :class:`~strom_torch.tune.knobs.Knob` surfaces
and a ``metrics_fn`` giving the live objective (higher is better: goodput
for a training context, items/s for a bench arm) and the SLO-burn flag.
``step()`` advances a two-beat state machine:

- **propose**: take the next knob round-robin and move it one step in its
  remembered direction (flipping at a bound), leaving the move in flight;
- **evaluate** (the next call, one settle window later): keep the move
  only when the objective rose by at least ``epsilon``; anything else is
  reverted exactly, and a drop past ``guard_frac`` also halves the knob's
  step.

Safety: a trial stays applied only if it measured better, so the tuned
state only drifts upward from the hand-set start (what ``tuned_vs_hand >=
1.0`` rides on); while ``slo_burning`` is reported the tuner reverts any
trial in flight and proposes nothing (``tune_holds``).

The tuner thread (``start()``) is optional; tests and bench arms call
``step()`` directly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Callable, Sequence

from strom_torch.tune.knobs import Knob
from strom_torch.utils.locks import make_lock

# the numeric leaves of stats()["tune"], which the /tune route serves
TUNE_FIELDS = (
    "tune_active",
    "tune_moves",
    "tune_reverts",
    "tune_holds",
    "tune_trials",
    "tune_objective",
    "tune_baseline_objective",
    "tune_best_objective",
    "tuned_vs_baseline",
)

# the columns of the reference's tune bench arm and its nvme arm's SQPOLL
# A/B (the hand/tuned A/B emits the first six)
TUNE_BENCH_FIELDS = (
    "hand_items_per_s",
    "tuned_items_per_s",
    "tuned_vs_hand",
    "tune_moves",
    "tune_reverts",
    "tune_holds",
    "engine_fixed_buf_ratio",
    "engine_unregistered_reads",
    "plain_submit_syscalls_per_gb",
    "sqpoll_submit_syscalls_per_gb",
    "sqpoll_active",
)


def stall_weighted_metrics(base_fn: Callable[[], dict], *,
                           wait_weight: float = 0.5) -> Callable[[], dict]:
    """Wrap a ``metrics_fn`` so the objective also penalizes the
    ingest-wait share, not just rewards goodput.

    The base fn's stall-attribution rates (``stall_<bucket>_us_per_s``,
    published by ``StromContext._tune_metrics``) give the split of step
    wall time between waiting on ingest and computing. The wrapped
    objective is ``objective * (1 - wait_weight * share)`` with
    ``share = ingest_wait / (ingest_wait + compute)`` — two knob settings
    with equal goodput now rank by how much accelerator time each one
    leaves stalled, steering the search toward settings with headroom
    instead of ones barely keeping up. Without the rates (no step windows
    yet, history off) the metrics pass through untouched, so the wrapper
    is safe as a default."""
    w = min(max(float(wait_weight), 0.0), 1.0)

    def metrics() -> dict:
        m = dict(base_fn())
        wait = m.get("stall_ingest_wait_us_per_s")
        comp = m.get("stall_compute_us_per_s")
        if wait is not None and comp is not None and (wait + comp) > 0:
            share = min(max(wait / (wait + comp), 0.0), 1.0)
            m["ingest_wait_share"] = round(share, 4)
            m["objective"] = float(m.get("objective", 0.0)) \
                * (1.0 - w * share)
        return m

    return metrics


@dataclasses.dataclass
class Profile:
    """A persisted knob assignment: what the tuner converged to for one
    workload (bench arm), reloadable so the next run starts there."""

    name: str
    knobs: dict[str, float]
    objective: float = 0.0

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"name": self.name, "knobs": self.knobs,
                       "objective": self.objective}, f, indent=2)
        os.replace(tmp, path)  # atomic: a crashed save never truncates

    @classmethod
    def load(cls, path: str) -> "Profile":
        with open(path) as f:
            d = json.load(f)
        return cls(name=str(d.get("name", "default")),
                   knobs={str(k): float(v)
                          for k, v in dict(d.get("knobs", {})).items()},
                   objective=float(d.get("objective", 0.0)))


class Autotuner:
    def __init__(self, knobs: Sequence[Knob],
                 metrics_fn: Callable[[], dict], *,
                 interval_s: float = 1.0,
                 guard_frac: float = 0.10,
                 epsilon: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 scope=None,
                 profile_name: str = "default"):
        if not 0.0 < guard_frac <= 1.0:
            raise ValueError("guard_frac must be in (0, 1]")
        self.knobs = list(knobs)
        self.metrics_fn = metrics_fn
        self.interval_s = float(interval_s)
        self.guard_frac = float(guard_frac)
        self.epsilon = float(epsilon)
        self.clock = clock
        self.profile_name = profile_name
        self._scope = scope
        # guards the counters/state below ONLY — metrics_fn and knob.set
        # both run outside it (metrics_fn walks the context's stats locks;
        # holding app.tune across that would invert the hierarchy)
        self._lock = make_lock("app.tune")
        self._knob_i = 0
        self._dir = {k.name: 1.0 for k in self.knobs}
        self._step = {k.name: float(k.step) for k in self.knobs}
        self._flips = {k.name: 0 for k in self.knobs}
        self._pending: tuple[Knob, float, float] | None = None
        self._ref: float | None = None         # tracked accepted objective
        self._baseline: float | None = None    # FIRST measurement, fixed
        self._best: float | None = None
        self._moves = self._reverts = self._holds = self._trials = 0
        self._objective = 0.0
        self._last_move = ""
        self._last_move_t = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- the control loop ----------------------------------------------------
    def step(self) -> str:
        """One controller beat; returns what it did (``"hold"``,
        ``"accept"``, ``"revert"``, ``"propose"``, ``"idle"``)."""
        m = self.metrics_fn() or {}
        obj = float(m.get("objective", 0.0))
        burning = bool(m.get("slo_burning", False))
        with self._lock:
            self._objective = obj
            if self._baseline is None:
                self._baseline = obj
                self._ref = obj
                self._best = obj
            pending, self._pending = self._pending, None
        if burning:
            # SLO hold: revert the in-flight trial (its effect is part of
            # whatever is burning) and propose nothing until clean
            if pending is not None:
                knob, old, _new = pending
                knob.set(old)
            with self._lock:
                self._holds += 1
                self._note_move("hold (slo burning)")
            self._scope_add("tune_holds")
            return "hold"
        if pending is not None:
            return self._evaluate(pending, obj)
        return self._propose(obj)

    def _evaluate(self, pending: tuple[Knob, float, float],
                  obj: float) -> str:
        knob, old, new = pending
        with self._lock:
            self._trials += 1
            ref = self._ref if self._ref is not None else 0.0
        # ABSOLUTE margins on a |ref|-scale: relative (1 +/- frac) margins
        # invert for objectives that pass through zero or go negative
        # (goodput deltas, negative synthetic landscapes)
        scale = max(abs(ref), 1.0)
        if obj >= ref + self.epsilon * scale:
            with self._lock:
                self._moves += 1
                self._ref = obj
                if self._best is None or obj > self._best:
                    self._best = obj
                self._flips[knob.name] = 0
                self._note_move(f"{knob.name} {old:g}->{new:g} accepted")
            self._scope_add("tune_moves")
            return "accept"
        # not better: exact revert (the safety contract — tuned state only
        # ever drifts upward from the hand baseline)
        knob.set(old)
        with self._lock:
            self._reverts += 1
            self._dir[knob.name] = -self._dir[knob.name]
            self._flips[knob.name] += 1
            if obj < ref - self.guard_frac * scale:
                # hard regression: the step overshot, not just the wrong
                # direction — halve it (floored at the knob's min_step so
                # refinement never collapses below the quantization grid)
                self._step[knob.name] = max(self._step[knob.name] / 2,
                                            knob.step_floor)
            if self._flips[knob.name] >= 2:
                # both directions measured worse: this knob is locally
                # converged — move on and shrink its step for next visit
                self._flips[knob.name] = 0
                self._step[knob.name] = max(self._step[knob.name] / 2,
                                            knob.step_floor)
                self._knob_i += 1
            # a revert still refreshes the tracked reference (slowly): a
            # drifting workload must not strand the tuner comparing
            # against a stale good epoch
            self._ref = 0.7 * ref + 0.3 * obj
            self._note_move(f"{knob.name} {new:g}->{old:g} reverted")
        self._scope_add("tune_reverts")
        return "revert"

    def _propose(self, obj: float) -> str:
        with self._lock:
            ref = self._ref if self._ref is not None else obj
            # idle refresh: between trials the measurement IS the accepted
            # state — track it so ref follows workload drift
            self._ref = 0.7 * ref + 0.3 * obj
            if self._best is None or obj > self._best:
                self._best = obj
        if not self.knobs:
            return "idle"
        for _ in range(len(self.knobs)):
            with self._lock:
                knob = self.knobs[self._knob_i % len(self.knobs)]
                direction = self._dir[knob.name]
                step = self._step[knob.name]
            cur = float(knob.get())
            cand = knob.clamp(cur + direction * step)
            if cand == cur:
                cand = knob.clamp(cur - direction * step)
                if cand == cur:  # pinned both ways (degenerate bounds)
                    with self._lock:
                        self._knob_i += 1
                    continue
                with self._lock:
                    self._dir[knob.name] = -direction
            knob.set(cand)
            with self._lock:
                self._pending = (knob, cur, cand)
                self._note_move(f"{knob.name} {cur:g}->{cand:g} trial")
            return "propose"
        return "idle"

    def settle(self) -> str:
        """Evaluate the in-flight trial (if any) against the current
        objective WITHOUT proposing a new one — the terminal beat for
        bench arms, which must measure the converged state, not a
        half-evaluated experiment. Returns ``"accept"``, ``"revert"``
        or ``"idle"``."""
        m = self.metrics_fn() or {}
        obj = float(m.get("objective", 0.0))
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return "idle"
        if bool(m.get("slo_burning", False)):
            knob, old, _new = pending
            knob.set(old)
            with self._lock:
                self._holds += 1
                self._note_move("hold (slo burning)")
            self._scope_add("tune_holds")
            return "revert"
        return self._evaluate(pending, obj)

    def _note_move(self, text: str) -> None:
        # caller holds self._lock
        self._last_move = text
        self._last_move_t = self.clock()

    def _scope_add(self, name: str) -> None:
        sc = self._scope
        if sc is not None:
            with contextlib.suppress(Exception):
                sc.add(name)

    # -- profiles ------------------------------------------------------------
    def profile(self) -> Profile:
        return Profile(name=self.profile_name,
                       knobs={k.name: float(k.get()) for k in self.knobs},
                       objective=float(self._best or 0.0))

    def apply_profile(self, profile: Profile) -> int:
        """Set every knob the profile names (clamped to the knob's live
        bounds); unknown names are ignored — a profile saved on a bigger
        box must not wedge a smaller one. Returns knobs applied."""
        by_name = {k.name: k for k in self.knobs}
        applied = 0
        for name, value in profile.knobs.items():
            knob = by_name.get(name)
            if knob is None:
                continue
            knob.set(knob.clamp(float(value)))
            applied += 1
        with self._lock:
            self.profile_name = profile.name
            self._note_move(f"profile {profile.name} applied")
        return applied

    # -- the tuner thread ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="strom-tune",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                # the tuner is advisory: a step that raises (a context
                # mid-close, a knob surface gone) must not kill the
                # thread; it is counted as tune_step_errors
                self._scope_add("tune_step_errors")

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        # leave knobs where the search put them: close() is not a revert —
        # callers that want the hand state back apply their own profile

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            baseline = self._baseline
            best = self._best
            out = {
                "tune_active": int(self._thread is not None),
                "tune_moves": self._moves,
                "tune_reverts": self._reverts,
                "tune_holds": self._holds,
                "tune_trials": self._trials,
                "tune_objective": round(self._objective, 4),
                "tune_baseline_objective": round(baseline or 0.0, 4),
                "tune_best_objective": round(best or 0.0, 4),
                # >= 1.0 by construction (only measured-better moves
                # persist); the bench gate's tuned_vs_hand reads the same
                # quantity measured externally across phases
                "tuned_vs_baseline": round(
                    (best / baseline) if baseline and best else 1.0, 4),
                "tune_profile": self.profile_name,
                "tune_last_move": self._last_move,
            }
        out["tune_knobs"] = {k.name: float(k.get()) for k in self.knobs}
        return out
