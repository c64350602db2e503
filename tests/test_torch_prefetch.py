"""The port's auto prefetch depth against the reference's: the feedback
controller (grow on stalls, shrink when the queue runs fully ready, stay
inside [min_depth, max_depth]) and ``bound_depth``, each case run through
``strom.delivery.prefetch`` and ``strom_torch.delivery.prefetch``. A
scripted executor, whose batches are ready or late by a fixed schedule and
never by a clock, must give both the same depth trajectory and the same
counts. The pipelines' wiring (``_auto_depth_bounds``) is checked against
the reference's too."""

import concurrent.futures
import time

import pytest

from strom.delivery import prefetch as jprefetch
from strom.pipelines import base as jbase
from strom_torch.config import StromConfig
from strom_torch.delivery import prefetch as tprefetch
from strom_torch.pipelines import base as tbase

PACKAGES = pytest.mark.parametrize("mod", [jprefetch, tprefetch],
                                   ids=["jax_package", "port"])


def snap(pf) -> dict:
    """The counters under the reference's names, from either package."""
    stats = getattr(pf, "stats", None)
    return stats.snapshot() if stats is not None else pf.snapshot()


def make_thunks(n, read_time):
    def thunk(i):
        def run():
            time.sleep(read_time)
            return i
        return run
    return [thunk(i) for i in range(n)]


@PACKAGES
class TestAutoDepth:
    """tests/test_prefetch.py::TestAutoDepth over both packages."""

    def test_grows_under_stalls(self, mod):
        pf = mod.Prefetcher(make_thunks(30, 0.015), depth=1, auto_depth=True,
                            max_depth=8)
        out = list(pf)
        assert out == list(range(30))
        assert pf.depth > 1
        assert snap(pf)["depth_grow"] >= 1
        assert pf.depth_trace[0] == (0, 1)
        assert pf.depth_trace[-1][1] == pf.depth

    def test_respects_max_depth_bound(self, mod):
        pf = mod.Prefetcher(make_thunks(40, 0.01), depth=1, auto_depth=True,
                            max_depth=3)
        for _ in pf:
            pass
        assert pf.depth <= 3
        assert max(d for _, d in pf.depth_trace) <= 3

    def test_shrinks_when_lead_ample(self, mod):
        pf = mod.Prefetcher(make_thunks(60, 0.0), depth=8, auto_depth=True,
                            min_depth=2, max_depth=8)
        for _ in pf:
            time.sleep(0.005)
        assert 2 <= pf.depth < 8
        assert snap(pf)["depth_shrink"] >= 1

    def test_min_depth_floor(self, mod):
        pf = mod.Prefetcher(make_thunks(80, 0.0), depth=4, auto_depth=True,
                            min_depth=3, max_depth=8)
        for _ in pf:
            time.sleep(0.003)
        assert pf.depth >= 3

    def test_lead_time_recorded(self, mod):
        pf = mod.Prefetcher(make_thunks(10, 0.0), depth=2, auto_depth=True)
        for _ in pf:
            time.sleep(0.004)
        s = snap(pf)
        assert s.get("lead_count", 0) >= 1
        assert s["prefetch_depth"] == pf.depth

    def test_fixed_depth_never_moves(self, mod):
        pf = mod.Prefetcher(make_thunks(20, 0.01), depth=2)
        for _ in pf:
            pass
        assert pf.depth == 2
        s = snap(pf)
        assert s.get("depth_grow", 0) == 0
        assert s.get("depth_shrink", 0) == 0

    def test_order_preserved_while_depth_moves(self, mod):
        def thunk(i):
            def run():
                time.sleep(0.03 if i % 7 == 3 else 0.001)
                return i
            return run

        pf = mod.Prefetcher([thunk(i) for i in range(50)], depth=2,
                            auto_depth=True, max_depth=6)
        out = []
        for x in pf:
            time.sleep(0.004)
            out.append(x)
        assert out == list(range(50))

    def test_set_depth_clamps(self, mod):
        pf = mod.Prefetcher(make_thunks(6, 0.0), depth=2, auto_depth=True,
                            min_depth=2, max_depth=4)
        pf.set_depth(9)
        assert pf.depth == 4
        pf.set_depth(0)
        assert pf.depth == 2
        assert [d for _, d in pf.depth_trace] == [2, 4, 2]
        assert list(pf) == list(range(6))


@PACKAGES
def test_bound_depth_by_slab_pool(mod):
    assert mod.bound_depth(512 << 20, 64 << 20) == 8
    assert mod.bound_depth(512 << 20, 1 << 20, cap=16) == 16
    assert mod.bound_depth(16 << 20, 64 << 20) == 2
    assert mod.bound_depth(0, 64 << 20) == 32
    assert mod.bound_depth(512 << 20, 0) == 32


@PACKAGES
def test_bound_depth_reserves_hot_cache_budget(mod):
    assert mod.bound_depth(512 << 20, 64 << 20, reserve_bytes=256 << 20) == 4
    assert mod.bound_depth(512 << 20, 64 << 20, reserve_bytes=512 << 20) == 2
    assert mod.bound_depth(512 << 20, 64 << 20, reserve_bytes=1 << 40,
                           floor=3) == 3
    assert mod.bound_depth(512 << 20, 64 << 20, reserve_bytes=0) == 8
    assert mod.bound_depth(0, 64 << 20, reserve_bytes=256 << 20) == 32


class _LateFuture(concurrent.futures.Future):
    """Not done until its result is asked for: a batch the consumer reaches
    before it is ready (a stall), whatever the clock says."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def result(self, timeout=None):
        if not self.done():
            self.set_result(self._fn())
        return super().result(timeout)


class ScriptedExecutor:
    """Runs batch i at submit unless *late* holds i; a late batch runs when
    the consumer asks for it. No threads, no timing."""

    _max_workers = 64

    def __init__(self, late):
        self.late = set(late)
        self.submitted = 0

    def submit(self, fn):
        i = self.submitted
        self.submitted += 1
        if i in self.late:
            return _LateFuture(fn)
        fut = concurrent.futures.Future()
        fut.set_result(fn())
        return fut

    def shutdown(self, wait=True):
        pass


def _run_script(mod, n, late, **kw):
    pf = mod.Prefetcher([lambda i=i: i for i in range(n)],
                        executor=ScriptedExecutor(late), auto_depth=True, **kw)
    out = list(pf)
    s = snap(pf)
    return out, list(pf.depth_trace), {k: s.get(k, 0) for k in (
        "steps", "data_stall_steps", "depth_grow", "depth_shrink")}


# (n batches, late batches, Prefetcher arguments)
SCRIPTS = [
    (60, {0, 1, 2, 3}, dict(depth=1, max_depth=8)),
    (80, {0, 5, 6, 30, 31, 32, 33, 34, 70}, dict(depth=2, max_depth=16)),
    (60, set(range(0, 60, 9)), dict(depth=4, min_depth=2, max_depth=6)),
    (50, set(), dict(depth=8, min_depth=1, max_depth=8)),
]


@pytest.mark.parametrize("n,late,kw", SCRIPTS)
def test_scripted_schedule_same_trajectory(n, late, kw):
    """The same ready/late schedule through both controllers: the same
    batches in order, the same depth trajectory, the same counts."""
    want = _run_script(jprefetch, n, late, **kw)
    got = _run_script(tprefetch, n, late, **kw)
    assert got == want
    assert got[0] == list(range(n))
    assert got[2]["data_stall_steps"] >= (1 if late else 0)


class _Ctx:
    def __init__(self, config):
        self.config = config


@pytest.mark.parametrize("auto,cfg_auto,batch_bytes,cache", [
    (None, False, 64 << 20, 0), (True, False, 64 << 20, 0),
    (None, True, 64 << 20, 256 << 20), (True, True, 1 << 20, 0),
    (False, True, 64 << 20, 0)])
def test_auto_depth_bounds_match_reference(auto, cfg_auto, batch_bytes,
                                           cache):
    """The pipelines' (auto_depth, max_depth) from the same settings."""
    from strom.config import StromConfig as JConfig

    kw = dict(prefetch_auto=cfg_auto, prefetch_max_depth=12,
              hot_cache_bytes=cache)
    want = jbase._auto_depth_bounds(_Ctx(JConfig(**kw)), auto, batch_bytes)
    got = tbase._auto_depth_bounds(_Ctx(StromConfig(**kw)), auto, batch_bytes)
    assert got == want


@pytest.mark.parametrize("field,value,match", [
    ("prefetch_max_depth", 0, "prefetch_max_depth"),
    ("hot_cache_bytes", -1, "hot_cache_bytes"),
    ("hot_cache_admit", "lru", "hot_cache_admit"),
    ("hot_cache_block_bytes", 1000, "hot_cache_block_bytes"),
    ("readahead_window_batches", -1, "readahead_window_batches")])
def test_config_validation_matches_reference(field, value, match):
    from strom.config import StromConfig as JConfig

    for cls in (JConfig, StromConfig):
        with pytest.raises(ValueError, match=match):
            cls(**{field: value})
    defaults = {f: getattr(StromConfig(), f) for f in (
        "prefetch_auto", "prefetch_max_depth", "hot_cache_bytes",
        "hot_cache_admit", "hot_cache_block_bytes",
        "readahead_window_batches", "decode_cache")}
    assert defaults == {f: getattr(JConfig(), f) for f in defaults}
