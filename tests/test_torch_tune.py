"""The port's knob autotuner held to the JAX package's: over one
deterministic objective (a seeded single-peak landscape per knob) both
controllers take the same sequence of proposals, accepts, reverts and
holds, end at the same knob values with the same counters, and save the
same ``Profile`` JSON. The knob surfaces ``standard_knobs`` builds over a
context (the scheduler's slice, the cache budget, the decode pool's run
target, the readahead window) and ``prefetcher_knob`` carry the
reference's names, bounds and steps; ``attach_tuner`` and ``tune=True``
arm the controller on a context, and ``_tune_metrics`` holds while no
goodput is known."""

import json

import numpy as np
import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.delivery.prefetch import Prefetcher as JPrefetcher
from strom.formats.jpeg import DecodePool as JDecodePool
from strom import tune as jtune
from strom_torch import tune as ttune
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.prefetch import Prefetcher
from strom_torch.formats.jpeg import DecodePool

PKGS = {"jax": jtune, "torch": ttune}


class Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class Landscape:
    """objective = peak - sum_i w_i (x_i - opt_i)^2 over a few knobs
    (above 0 on the whole box), with a burn schedule: the SLO burns on the
    beats listed."""

    def __init__(self, seed: int, tune_mod) -> None:
        rng = np.random.default_rng(seed)
        self.n = 1 + seed % 3
        self.opt = [float(v) for v in rng.integers(2, 18, self.n)]
        self.w = [float(v) for v in rng.uniform(0.5, 3.0, self.n)]
        self.x = [float(v) for v in rng.integers(0, 20, self.n)]
        self.burn_beats = set(int(b) for b in rng.integers(0, 60, 4))
        self.beat = 0
        self.knobs = [tune_mod.Knob(
            name=f"k{i}", get=lambda i=i: self.x[i],
            set=lambda v, i=i: self.x.__setitem__(i, float(v)),
            lo=0.0, hi=20.0, step=float(1 + i),
            quantize=lambda v: float(round(v)), min_step=1.0)
            for i in range(self.n)]

    def metrics(self) -> dict:
        obj = 5000.0 - sum(w * (x - o) ** 2
                          for w, x, o in zip(self.w, self.x, self.opt))
        return {"objective": obj, "slo_burning": self.beat in self.burn_beats}


def _run(mod, seed: int, beats: int = 60):
    land = Landscape(seed, mod)
    clock = Clock()
    tuner = mod.Autotuner(land.knobs, land.metrics, clock=clock,
                          guard_frac=0.1, profile_name=f"land{seed}")
    moves = []
    for b in range(beats):
        land.beat = b
        moves.append(tuner.step())
        clock.t += 1.0
    moves.append(tuner.settle())
    return land, tuner, moves


@pytest.mark.parametrize("seed", range(6))
def test_same_moves_knobs_counters_and_profile(seed, tmp_path):
    runs = {k: _run(mod, seed) for k, mod in PKGS.items()}
    (jl, jt, jm), (tl, tt, tm) = runs["jax"], runs["torch"]
    assert tm == jm
    assert set(tm) <= {"propose", "accept", "revert", "hold", "idle"}
    assert "hold" in tm                      # the burn schedule held it
    assert tl.x == jl.x
    assert tt.stats() == jt.stats()
    assert tt.stats()["tuned_vs_baseline"] >= 1.0
    for k, t in (("jax", jt), ("torch", tt)):
        t.profile().save(str(tmp_path / f"{k}.json"))
    assert json.load(open(tmp_path / "torch.json")) == \
        json.load(open(tmp_path / "jax.json"))
    prof = ttune.Profile.load(str(tmp_path / "torch.json"))
    assert prof.knobs == {k.name: k.get() for k in tl.knobs}


def test_fields_and_bench_columns_match():
    assert ttune.TUNE_FIELDS == jtune.TUNE_FIELDS
    assert ttune.TUNE_BENCH_FIELDS == jtune.TUNE_BENCH_FIELDS
    assert set(ttune.TUNE_FIELDS) <= set(_run(ttune, 0, 4)[1].stats())


@pytest.mark.parametrize("wait,comp", [(None, None), (300.0, 700.0),
                                       (0.0, 0.0), (900.0, 100.0)])
def test_stall_weighted_metrics_match(wait, comp):
    def base():
        m = {"objective": 80.0, "slo_burning": False}
        if wait is not None:
            m["stall_ingest_wait_us_per_s"] = wait
            m["stall_compute_us_per_s"] = comp
        return m

    got = {k: mod.stall_weighted_metrics(base, wait_weight=0.5)()
           for k, mod in PKGS.items()}
    assert got["torch"] == got["jax"]


def test_apply_profile_clamps_and_skips_unknown():
    for mod in PKGS.values():
        land = Landscape(1, mod)
        tuner = mod.Autotuner(land.knobs, land.metrics)
        n = tuner.apply_profile(mod.Profile("p", {"k0": 99.0, "nope": 1.0}))
        assert n == 1 and land.x[0] == 20.0


def _cfg(Cfg, **kw):
    return Cfg(engine="python", queue_depth=8, num_buffers=8,
               hot_cache_bytes=16 << 20, readahead_window_batches=2, **kw)


def _knob_facts(knobs) -> list:
    return [(k.name, k.lo, k.hi, k.step, k.step_floor, k.get())
            for k in knobs]


def test_standard_knobs_over_a_context_match():
    tctx, jctx = StromContext(_cfg(StromConfig)), JContext(_cfg(JConfig))
    pools = (DecodePool(2), JDecodePool(2))
    try:
        assert _knob_facts(ttune.standard_knobs(tctx)) == \
            _knob_facts(jtune.standard_knobs(jctx))
        tctx.register_tunable("decode_pool", pools[0])
        jctx.register_tunable("decode_pool", pools[1])
        tk = ttune.standard_knobs(tctx)
        assert _knob_facts(tk) == _knob_facts(jtune.standard_knobs(jctx))
        assert [k.name for k in tk] == ["sched_slice_bytes",
                                        "cache_budget_bytes",
                                        "decode_run_target_us"]
        # a move reaches the surface: the pool's run length follows it
        run = {k.name: k for k in tk}["decode_run_target_us"]
        run.set(8000.0)
        assert pools[0].run_target_us == 8000.0
        slice_knob = tk[0]
        slice_knob.set(slice_knob.clamp(slice_knob.lo))
        assert tctx.scheduler._slice_bytes() == int(slice_knob.lo)
    finally:
        for p in pools:
            p.close()
        tctx.close()
        jctx.close()


def test_prefetcher_knob_matches():
    facts = []
    for P, mod in ((Prefetcher, ttune), (JPrefetcher, jtune)):
        pf = P(iter([lambda i=i: i for i in range(40)]), depth=2,
               auto_depth=True, max_depth=6)
        k = mod.prefetcher_knob(pf)
        k.set(k.clamp(5.4))
        facts.append((_knob_facts([k]), pf.depth, list(pf)))
    assert facts[0] == facts[1]


def test_attach_tuner_and_metrics_hold_without_goodput():
    jctx = JContext(_cfg(JConfig))
    try:
        want = jctx._tune_metrics()
    finally:
        jctx.close()
    with StromContext(_cfg(StromConfig)) as ctx:
        assert ctx.tuner is None and "tune" not in ctx.stats()
        t = ctx.attach_tuner(start=False)
        assert ctx.attach_tuner() is t and ctx.tuner is t
        # no step window yet: the reference's objective, no history rates
        assert ctx._tune_metrics() == want
        ctx._current_goodput = lambda: None
        # goodput unknown reads as a hold
        assert ctx._tune_metrics() == {"objective": 0.0,
                                       "slo_burning": True}
        assert t.step() == "hold"
        st = ctx.stats(["tune"])["tune"]
        assert st["tune_holds"] == 1 and st["tune_active"] == 0
        assert set(st["tune_knobs"]) == {"sched_slice_bytes",
                                         "cache_budget_bytes"}


def test_config_tune_arms_the_thread_and_close_stops_it(tmp_path):
    prof = tmp_path / "arm.json"
    ttune.Profile("arm", {"cache_budget_bytes": 12 << 20}).save(str(prof))
    ctx = StromContext(_cfg(StromConfig, tune=True, tune_interval_s=0.01,
                            tune_profile=str(prof)))
    try:
        assert ctx.tuner is not None
        st = ctx.stats()["tune"]
        assert st["tune_active"] == 1 and st["tune_profile"] == "arm"
        assert ctx.hot_cache.max_bytes == 12 << 20
    finally:
        ctx.close()
    assert ctx.tuner.stats()["tune_active"] == 0


@pytest.mark.parametrize("kw", [dict(tune_interval_s=0.0),
                                dict(tune_guard_frac=0.0),
                                dict(tune_guard_frac=1.5),
                                dict(metrics_port=70000)])
def test_config_checks_match(kw):
    for Cfg in (StromConfig, JConfig):
        with pytest.raises(ValueError):
            Cfg(**kw)
