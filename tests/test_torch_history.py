"""The port's snapshot history held to the JAX package's: both rings fed
the same counter movement on fake clocks keep the same samples and give
the same ``rate()`` over every window (scoped series included, and None
where fewer than two samples cover the window); the ring is bounded; the
sampler thread samples and stops; the context builds the history with its
live server only."""

import time

import numpy as np
import pytest

from strom.obs import history as jhist
from strom.utils.stats import global_stats as j_stats
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.obs import history as thist
from strom_torch.utils.stats import global_stats as t_stats

PKGS = {"jax": (jhist, j_stats), "torch": (thist, t_stats)}


class Clock:
    def __init__(self) -> None:
        self.t = 50.0

    def __call__(self) -> float:
        return self.t


@pytest.mark.parametrize("seed", [0, 1])
def test_samples_and_rates_match(seed):
    rng = np.random.default_rng(seed)
    key, gkey = f"hist_probe_bytes_{seed}", f"hist_probe_depth_{seed}"
    label = f'tenant="hist{seed}"'
    runs = {}
    for k, (mod, reg) in PKGS.items():
        clock = Clock()
        h = mod.StatsHistory(interval_s=1.0, capacity=16, clock=clock,
                             start=False)
        runs[k] = (h, clock, reg)
    steps = rng.integers(0, 1 << 20, size=24)
    dts = rng.uniform(0.5, 3.0, size=24)
    for n, dt in zip(steps, dts):
        for h, clock, reg in runs.values():
            reg.add(key, int(n))
            reg.set_gauge(gkey, int(n) % 7)
            reg.scoped(tenant=f"hist{seed}").add(key, int(n) // 2)
            clock.t += float(dt)
            h.sample()
    (jh, _, _), (th, _, _) = runs["jax"], runs["torch"]
    keys = [key, gkey]
    assert th.samples(keys=keys) == jh.samples(keys=keys)
    assert len(th.samples()) == 16                 # the ring is bounded
    since = th.samples()[5]["ts_s"]
    assert th.samples(since, keys) == jh.samples(since, keys)
    assert th.snapshot(keys=keys) == jh.snapshot(keys=keys)
    for window in (None, 1.0, 5.0, 12.0, 1000.0):
        assert th.rate(key, window) == jh.rate(key, window), window
        assert th.rate(key, window, scope=label) == \
            jh.rate(key, window, scope=label)
    assert th.rate(key, 0.0) is None               # one sample: unknown
    assert th.rate("no_such_series") is None
    assert th.rate(key) > 0


def test_sampler_thread_samples_and_stops():
    h = thist.StatsHistory(interval_s=0.05)
    try:
        deadline = time.monotonic() + 5.0
        while len(h.samples()) < 2:
            assert time.monotonic() < deadline, "the sampler never ran"
            time.sleep(0.02)
    finally:
        h.close()
    n = len(h.samples())
    time.sleep(0.15)
    assert len(h.samples()) == n and h.sample_errors == 0
    assert thist.HISTORY_META_KEYS == jhist.HISTORY_META_KEYS


def test_context_builds_history_with_its_server_only():
    with StromContext(StromConfig(engine="python")) as ctx:
        assert ctx.history is None and ctx.metrics_server is None
    cfg = StromConfig(engine="python", history_interval_s=0.05)
    with StromContext(cfg, metrics_port=0) as ctx:
        assert ctx.history is not None
        assert ctx.history.interval_s == 0.05
    with StromContext(StromConfig(engine="python", history_interval_s=0.0),
                      metrics_port=0) as ctx:
        assert ctx.history is None and ctx.metrics_server is not None
