"""The port's lock-order witness (``strom_torch/utils/locks.py``), held to
the JAX package's (``strom/utils/locks.py``) case by case: each case runs
in both packages and must give the same edges, sites' keys, errors and
lock kinds. An inversion raises ``LockOrderError`` before the inner lock is
taken, a three-lock cycle is found, one role never cycles with itself, a
cycle dumps a loadable flight bundle, a condition's wait keeps the held
stack truthful, the factory is plain when off, and a context with
``debug_locks`` turns the witness on and its ``close()`` turns it off."""

import threading

import pytest

from strom.obs.flight import load_bundle as j_load_bundle
from strom.utils import locks as j_locks
from strom_torch.obs.flight import load_bundle
from strom_torch.utils import locks

PKGS = {"jax": (j_locks, j_load_bundle), "torch": (locks, load_bundle)}


@pytest.fixture
def witness_on():
    saved = {name: m.witness_enabled() for name, (m, _) in PKGS.items()}
    for m, _ in PKGS.values():
        m.witness.reset()
        m.enable_witness(True)
    try:
        yield
    finally:
        for name, (m, _) in PKGS.items():
            m.enable_witness(saved[name])
            m.witness.reset()
            m.set_flight_dir(None)


def _seed_inversion(mod, a, b):
    """Take a→b, then attempt b→a; returns the raised LockOrderError."""
    with a:
        with b:
            pass
    with pytest.raises(mod.LockOrderError) as ei:
        with b:
            with a:
                pass
    return ei.value


def _inversion(mod) -> tuple:
    a, b = mod.WitnessLock("t.a"), mod.WitnessLock("t.b")
    err = _seed_inversion(mod, a, b)
    assert all("test_torch_locks.py" in s for s in err.sites.values())
    return (err.edge, sorted(err.sites), a.locked(), b.locked(),
            str(err).split("\n")[0])


def _three_cycle(mod) -> tuple:
    a, b, c = (mod.WitnessLock(f"t3.{n}") for n in "abc")
    with a, b:
        pass
    with b, c:
        pass
    with pytest.raises(mod.LockOrderError) as ei:
        with c, a:
            pass
    err = ei.value
    return err.edge, sorted(err.sites), "3-lock cycle" in str(err)


def _same_role(mod) -> list:
    a1, a2 = mod.WitnessLock("t.same"), mod.WitnessLock("t.same")
    with a1, a2:
        pass
    with a2, a1:
        pass
    return sorted(mod.witness.edges())


def _condition(mod) -> list:
    cond = mod.make_condition("t.cond")
    other = mod.WitnessLock("t.other")
    with cond:
        cond.wait(0.01)
    with other, cond:
        pass
    return sorted(mod.witness.edges())


def _threads(mod) -> str:
    a, b = mod.WitnessLock("t.a"), mod.WitnessLock("t.b")

    def fwd():
        with a, b:
            pass

    t = threading.Thread(target=fwd, name="witness-fwd")
    t.start()
    t.join()
    with pytest.raises(mod.LockOrderError) as ei:
        with b, a:
            pass
    return type(ei.value).__name__


CASES = {"inversion": _inversion, "three_cycle": _three_cycle,
         "same_role": _same_role, "condition": _condition,
         "threads": _threads}


@pytest.mark.parametrize("case", sorted(CASES))
def test_witness_case_matches_reference(case, witness_on):
    got = {name: CASES[case](m) for name, (m, _) in PKGS.items()}
    assert got["torch"] == got["jax"]


def test_inversion_raises_before_acquiring(witness_on):
    edge, sites, a_locked, b_locked, _ = _inversion(locks)
    assert edge == ("t.b", "t.a")
    assert sites == ["t.a -> t.b", "t.b -> t.a"]
    assert not a_locked and not b_locked


def test_three_lock_cycle_names_every_edge(witness_on):
    edge, sites, named = _three_cycle(locks)
    assert edge == ("t3.c", "t3.a") and named
    assert sites == ["t3.a -> t3.b", "t3.b -> t3.c", "t3.c -> t3.a"]


def test_condition_wait_keeps_held_stack_truthful(witness_on):
    assert "t.other -> t.cond" in _condition(locks)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_cycle_dumps_loadable_flight_bundle(pkg, witness_on, tmp_path):
    mod, load = PKGS[pkg]
    mod.set_flight_dir(str(tmp_path))
    _seed_inversion(mod, mod.WitnessLock("t.a"), mod.WitnessLock("t.b"))
    bundles = [d for d in tmp_path.iterdir() if d.name.startswith("flight-")]
    assert len(bundles) == 1
    doc = load(str(bundles[0]))
    assert doc["manifest"]["reason"] == "lock_order"
    assert "lock order inversion" in doc["manifest"]["note"]
    assert doc["stacks"] and doc["trace"]["traceEvents"] is not None


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_factory_is_plain_when_off(pkg):
    mod, _ = PKGS[pkg]
    prev = mod.witness_enabled()
    mod.enable_witness(False)
    try:
        assert type(mod.make_lock("t.plain")) is type(threading.Lock())
        cond = mod.make_condition("t.plain_cond")
        assert isinstance(cond, threading.Condition)
        assert not isinstance(cond._lock, mod.WitnessLock)
    finally:
        mod.enable_witness(prev)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_factory_is_witnessed_when_on(pkg, witness_on):
    mod, _ = PKGS[pkg]
    assert isinstance(mod.make_lock("t.w"), mod.WitnessLock)
    assert isinstance(mod.make_condition("t.wc")._lock, mod.WitnessLock)


def test_context_enables_the_witness_and_close_reverts_it(witness_on):
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext

    locks.enable_witness(False)
    ctx = StromContext(StromConfig(debug_locks=True, engine="python",
                                   slab_pool_bytes=0))
    try:
        assert locks.witness_enabled()
        # the engine and the scheduler were built after it went on
        assert isinstance(ctx.engine._lock, locks.WitnessLock)
        assert isinstance(ctx.scheduler._cond._lock, locks.WitnessLock)
    finally:
        ctx.close()
    assert not locks.witness_enabled()


def test_context_leaves_a_witness_it_did_not_enable(witness_on):
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext

    ctx = StromContext(StromConfig(debug_locks=True, engine="python",
                                   slab_pool_bytes=0))
    ctx.close()
    assert locks.witness_enabled()


def test_hot_cache_and_pool_run_clean_under_the_witness(witness_on):
    """The hot cache's admit/evict/lookup and the slab pool's recycling
    run under the witness without a cycle."""
    import numpy as np

    from strom_torch.delivery.buffers import SlabPool
    from strom_torch.delivery.hotcache import HotCache

    pool = SlabPool(1 << 22)
    cache = HotCache(1 << 16, admit="always", block_bytes=4096)
    data = np.zeros(1 << 15, dtype=np.uint8)
    for i in range(6):
        slab = pool.acquire(4096)
        cache.admit(f"f{i}", 0, data.nbytes, data)
        hits, misses, pinned = cache.lookup(f"f{i}", 0, 4096)
        cache.unpin(pinned)
        pool.release(slab)
    cache.clear()
    assert cache.entries == 0
