"""A failed streamed delivery keeps no slab. The rule: a slab goes back to
the pool only once no engine piece and no copy can still touch it, and no
registered slab outlives the pool. On the CPU the pool pins nothing, and
its ``on_alloc`` / ``on_free`` hooks (the engine's ring registration on
the card) count what is registered: after a delivery whose piece fails,
one whose copy event raises, and one whose piece the engine abandoned at
a deadline, ``slab_in_use_bytes`` reads 0 and, once the context has
closed, every slab the hooks registered has been unregistered."""

import json

import numpy as np
import pytest
import torch

from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import SlabPool, alloc_aligned
from strom_torch.delivery.core import StromContext
from strom_torch.engine.base import (DeadlineExceeded, EngineError,
                                     may_still_write)

MiB = 1 << 20
CFG = dict(engine="python", queue_depth=8, num_buffers=16,
           hot_cache_bytes=0, residency_hybrid=False, breaker_enabled=False,
           overlap_chunk_bytes=256 * 1024, overlap_min_bytes=512 * 1024,
           io_retries=1, io_retry_backoff_s=0.001,
           io_retry_backoff_max_s=0.002)


class _Hooks:
    def __init__(self):
        self.live: dict[int, int] = {}
        self.allocs = self.frees = 0

    def on_alloc(self, slab):
        self.allocs += 1
        self.live[slab.__array_interface__["data"][0]] = slab.nbytes

    def on_free(self, slab):
        self.frees += 1
        del self.live[slab.__array_interface__["data"][0]]


def _ctx(**kw):
    ctx = StromContext(StromConfig(**{**CFG, **kw}))
    hooks = _Hooks()
    pool = SlabPool(8 * MiB, pin=False, on_alloc=hooks.on_alloc,
                    on_free=hooks.on_free)
    ctx._slab_pool = pool
    return ctx, pool, hooks


def _check_closed(ctx, pool, hooks):
    assert pool.stats()["slab_in_use_bytes"] == 0
    ctx.close()
    st = pool.stats()
    assert st["registered_slabs"] == 0 and st["parked_bytes"] == 0
    assert hooks.live == {} and hooks.allocs == hooks.frees > 0


def _eio(times: int) -> str:
    return json.dumps({"seed": 0, "rules": [
        {"kind": "errno", "op": "read", "op_lo": 3, "times": times}]})


def test_failed_piece_returns_its_slab(data_file):
    path, golden = data_file
    # one op fails more times than io_retries: the delivery raises
    ctx, pool, hooks = _ctx(fault_plan=_eio(4))
    with pytest.raises(EngineError):
        ctx.memcpy_ssd2gpu(path, length=2 * MiB, device="cpu")
    assert pool.stats()["slab_in_use_bytes"] == 0
    assert pool.stats()["parked_bytes"] == 0
    # a clean delivery in the same context, exact, reusing the slabs
    got = ctx.memcpy_ssd2gpu(path, offset=2 * MiB, length=2 * MiB,
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), golden[2 * MiB: 4 * MiB])
    assert pool.stats()["hits"] > 0
    _check_closed(ctx, pool, hooks)


def test_copy_event_that_raises_returns_every_slab(data_file, monkeypatch):
    path, golden = data_file
    ctx, pool, hooks = _ctx()
    real = ctx._copy_async
    calls = [0]

    class _Failing:
        @staticmethod
        def synchronize():
            raise RuntimeError("copy event failed")

    def copy(dst, slab, stream):
        ev = real(dst, slab, stream)
        calls[0] += 1
        return _Failing() if calls[0] == 2 else ev

    monkeypatch.setattr(ctx, "_copy_async", copy)
    with pytest.raises(RuntimeError, match="copy event failed"):
        ctx.memcpy_ssd2gpu(path, length=2 * MiB, device="cpu")
    assert pool.stats()["slab_in_use_bytes"] == 0
    monkeypatch.undo()
    got = ctx.memcpy_ssd2gpu(path, length=2 * MiB, device="cpu")
    np.testing.assert_array_equal(got.numpy(), golden[:2 * MiB])
    _check_closed(ctx, pool, hooks)


def test_retire_waits_on_every_event_and_raises_the_first(monkeypatch):
    """The drain hands back every slab, in order, even when two waits
    raise; the first error is the one raised."""
    import collections

    ctx, pool, hooks = _ctx()
    order = []

    class _Ev:
        def __init__(self, i, err):
            self.i, self.err = i, err

        def synchronize(self):
            order.append(self.i)
            if self.err:
                raise RuntimeError(f"event {self.i}")

    slabs = [pool.acquire(4096) for _ in range(4)]
    inflight = collections.deque(
        (_Ev(i, i in (1, 2)), s) for i, s in enumerate(slabs))
    with pytest.raises(RuntimeError, match="event 1"):
        ctx._retire(inflight, True)
    assert order == [0, 1, 2, 3] and not inflight
    _check_closed(ctx, pool, hooks)


def test_abandoned_piece_parks_its_slab(data_file):
    """Every read is held forever and the request's deadline passes: the
    engine abandons the piece after its drain grace, and its slab is
    parked (never reused, still registered) until the context closes."""
    path, _ = data_file
    stuck = json.dumps({"seed": 0, "rules": [{"kind": "stuck"}]})
    ctx, pool, hooks = _ctx(fault_plan=stuck, request_deadline_s=0.2,
                            hedge_enabled=False)
    with pytest.raises(DeadlineExceeded):
        ctx.memcpy_ssd2gpu(path, length=2 * MiB, device="cpu")
    st = pool.stats()
    assert st["slab_in_use_bytes"] == 0 and st["parked_bytes"] > 0
    assert len(hooks.live) == st["registered_slabs"] > 0
    _check_closed(ctx, pool, hooks)


def test_may_still_write_tracks_an_engine_until_it_closes():
    ctx, pool, hooks = _ctx()
    slab = alloc_aligned(8192)
    addr = slab.__array_interface__["data"][0]
    assert not may_still_write(slab)
    ctx.engine._note_abandoned([(addr + 4096, 512)])
    assert may_still_write(slab)
    assert may_still_write(slab[4096:])
    assert not may_still_write(slab[:4096])
    out = pool.acquire(8192)
    ctx.engine._note_abandoned(
        [(out.__array_interface__["data"][0], 4096)])
    ctx._release_failed(out, True)
    assert pool.stats()["parked_bytes"] == 8192
    ctx.close()
    assert not may_still_write(slab)
    assert pool.stats()["registered_slabs"] == 0 and hooks.live == {}


def test_pool_close_unregisters_slabs_still_out():
    hooks = _Hooks()
    pool = SlabPool(1 * MiB, pin=False, on_alloc=hooks.on_alloc,
                    on_free=hooks.on_free)
    out = pool.acquire(64 * 1024)
    kept = pool.acquire(64 * 1024)
    pool.release(kept)
    pool.close()
    assert hooks.live == {} and pool.stats()["registered_slabs"] == 0
    pool.release(out)      # coming back after close: nothing left to do
    assert hooks.frees == 2


def test_cpu_streamed_delivery_without_a_pool_is_unchanged(data_file):
    path, golden = data_file
    with StromContext(StromConfig(**CFG, slab_pool_bytes=0)) as ctx:
        streamed0 = ctx.stats()["context"]["streamed_transfers"]
        got = ctx.memcpy_ssd2gpu(path, length=2 * MiB, device="cpu")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), golden[:2 * MiB])
        assert ctx.stats()["context"]["streamed_transfers"] - streamed0 == 1
