"""The port's SLO engine held to the JAX package's: one seeded stream of
request observations on a fake clock gives both engines the same
``report()`` at every phase (the burning transition included: a burst of
bad requests burns both windows; once the fast window has aged past it,
the tenant stops burning while the slow window still remembers), the same
``stats()`` and ``slo_*`` gauges; the scheduler's ``slo_hook`` flags the
burning tenant's ``tenants_info()`` row in both packages; a context's
observer counts the context's own requests only."""

import numpy as np
import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.obs import slo as jslo
from strom.utils.stats import global_stats as j_stats
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.obs import slo as tslo
from strom_torch.utils.stats import global_stats as t_stats

PKGS = {"jax": (jslo, j_stats), "torch": (tslo, t_stats)}


class Clock:
    def __init__(self) -> None:
        self.t = 1_000.0

    def __call__(self) -> float:
        return self.t


def _engines(seed: int):
    out = {}
    for k, (mod, _) in PKGS.items():
        clock = Clock()
        eng = mod.SloEngine(fast_s=60, slow_s=600, bucket_s=10, clock=clock,
                            goodput_fn=lambda: 42.5)
        eng.set_target(f"tight{seed}", gather_p99_us=4_000.0,
                       objective_pct=90.0, goodput_pct=50.0)
        eng.set_target(f"loose{seed}", gather_p99_us=1e9, objective_pct=50.0)
        out[k] = (eng, clock)
    return out


def _feed(engines, rng, n: int, bad_frac: float, tenants) -> None:
    lat = rng.exponential(400.0, size=n)
    bad = rng.random(n) < bad_frac
    err = rng.random(n) < 0.02
    who = rng.integers(0, len(tenants), size=n)
    for i in range(n):
        for eng, _ in engines.values():
            eng.observe(tenants[who[i]],
                        float(lat[i] + (5_000.0 if bad[i] else 0.0)),
                        queue_wait_us=float(lat[i] / 4),
                        error=bool(err[i]))


def _advance(engines, dt: float) -> None:
    for _, clock in engines.values():
        clock.t += dt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_and_burning_transition_match(seed):
    engines = _engines(seed)
    tenants = [f"tight{seed}", f"loose{seed}", f"plain{seed}"]
    rng = np.random.default_rng(seed)
    reports = []
    _feed(engines, rng, 300, 0.5, tenants)          # a bad burst
    reports.append({k: e.report() for k, (e, _) in engines.items()})
    _advance(engines, 120.0)                        # past the fast window
    _feed(engines, rng, 200, 0.0, tenants)          # clean traffic
    reports.append({k: e.report() for k, (e, _) in engines.items()})
    _advance(engines, 700.0)                        # past the slow one too
    reports.append({k: e.report() for k, (e, _) in engines.items()})
    for rep in reports:
        assert rep["torch"] == rep["jax"]
    tight = [r["torch"]["tenants"][f"tight{seed}"] for r in reports]
    assert [t["slo_burning"] for t in tight] == [True, False, False]
    assert tight[1]["slo_burn_fast"] < 1.0 < tight[1]["slo_burn_slow"]
    assert tight[0]["goodput_pct"] == 42.5 and not tight[0]["goodput_ok"]
    assert not reports[0]["torch"]["tenants"][f"loose{seed}"]["slo_burning"]
    assert engines["torch"][0].stats() == engines["jax"][0].stats()


def test_gauges_worst_tenant_and_scoped():
    engines = _engines(9)
    _feed(engines, np.random.default_rng(9), 100, 0.6, ["tight9", "loose9"])
    for k, (eng, _) in engines.items():
        eng.report()
    for k, (_, reg) in PKGS.items():
        snap = reg.scoped(tenant="tight9").snapshot()
        assert snap["slo_burning"] == 1, k
        assert reg.scoped(tenant="loose9").snapshot()["slo_burning"] == 0
    assert t_stats.scoped(tenant="tight9").snapshot() == \
        {k: v for k, v in j_stats.scoped(tenant="tight9").snapshot().items()
         if k in tslo.SLO_FIELDS}
    assert tslo.SLO_FIELDS == jslo.SLO_FIELDS


def test_unknown_target_field_and_step_requests():
    for mod, _ in PKGS.values():
        with pytest.raises(TypeError):
            mod.SloEngine().set_target("a", gather_p99_uss=5)

        class Req:
            kind, tenant, dur_us, queue_wait_us, error = \
                "step", "a", 1e12, 0.0, None

        eng = mod.SloEngine(default_target=mod.SloTarget(gather_p99_us=1.0))
        eng.observe_request(Req())
        assert eng.tenants() == []


def _cfg(Cfg):
    return Cfg(engine="python", queue_depth=8, num_buffers=8)


def test_scheduler_hook_flags_the_burning_tenant(data_file):
    path, _ = data_file
    rows = {}
    for k, Ctx, Cfg in (("torch", StromContext, StromConfig),
                        ("jax", JContext, JConfig)):
        ctx = Ctx(_cfg(Cfg))
        try:
            ctx.register_tenant("slowhook", byte_rate=0)
            ctx.register_tenant("fasthook")
            # a target no read can meet: every request of it is bad
            ctx.slo.set_target("slowhook", gather_p99_us=0.001)
            for t in ("slowhook", "fasthook"):
                for _ in range(3):
                    ctx.pread(path, 0, 64 * 1024, tenant=t)
            info = ctx.scheduler.tenants_info()
            rows[k] = {n: info["tenants"][n]["slo_burning"]
                       for n in ("slowhook", "fasthook")}
            assert "resilience" in info
            rep = ctx.slo.report()["tenants"]
            assert rep["slowhook"]["requests"] == 3
            assert rep["fasthook"]["requests"] == 3
        finally:
            ctx.close()
    assert rows["torch"] == rows["jax"] == {"slowhook": True,
                                            "fasthook": False}


def test_a_context_counts_its_own_requests_only(data_file):
    path, _ = data_file
    a, b = StromContext(_cfg(StromConfig)), StromContext(_cfg(StromConfig))
    try:
        a.register_tenant("owner_a")
        for _ in range(4):
            a.pread(path, 0, 4096, tenant="owner_a")
        assert a.slo.report()["tenants"]["owner_a"]["requests"] == 4
        assert "owner_a" not in b.slo.tenants()
        assert a.stats(["slo"])["slo"]["slo_tenants"] >= 1
    finally:
        a.close()
        b.close()
    # a closed context's observer is gone: later requests do not reach it
    with StromContext(_cfg(StromConfig)) as c:
        c.pread(path, 0, 4096, tenant="owner_a")
    assert a.slo.report()["tenants"]["owner_a"]["requests"] == 4
