"""The port's DMAHandle beside the JAX package's on the CPU: done, wait,
result, exception, block_until_ready, elapsed_s, the handles_completed
counter and completed_handle / deferred_handle behave alike, and an async
ssd2gpu delivery's block_until_ready returns the delivered tensor."""

import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

from strom.delivery import handle as jh
from strom.utils.stats import global_stats as j_stats
from strom_torch.config import StromConfig
from strom_torch.delivery import handle as th
from strom_torch.delivery.core import StromContext
from strom_torch.utils.stats import global_stats as t_stats

MODS = [pytest.param(jh, j_stats, id="jax_package"),
        pytest.param(th, t_stats, id="port")]


@pytest.mark.parametrize("mod,stats", MODS)
def test_completed_handle(mod, stats):
    before = stats.counter("handles_completed").value
    h = mod.completed_handle(7, nbytes=3, label="x")
    assert h.done() and h.result() == 7 and h.exception() is None
    assert h.block_until_ready() == 7 and h.wait() is h
    assert h.nbytes == 3 and "x" in repr(h) and "done" in repr(h)
    assert 0.0 <= h.elapsed_s < 1.0
    assert stats.counter("handles_completed").value == before + 1


@pytest.mark.parametrize("mod,stats", MODS)
def test_deferred_handle_lifecycle(mod, stats):
    gate = threading.Event()
    ex = concurrent.futures.ThreadPoolExecutor(1)
    try:
        before = stats.counter("handles_completed").value
        h = mod.deferred_handle(lambda: (gate.wait(5), 42)[1], ex, 8, "y")
        assert not h.done() and "pending" in repr(h)
        with pytest.raises(concurrent.futures.TimeoutError):
            h.result(timeout=0.01)
        time.sleep(0.05)
        running = h.elapsed_s
        assert running >= 0.05
        gate.set()
        assert h.block_until_ready(timeout=5) == 42
        done_at = h.elapsed_s
        time.sleep(0.02)
        assert h.elapsed_s == done_at      # frozen once resolved
        assert h.exception() is None
        # the done callback may run just after result() returns
        for _ in range(100):
            if stats.counter("handles_completed").value == before + 1:
                break
            time.sleep(0.01)
        assert stats.counter("handles_completed").value == before + 1

        bad = mod.deferred_handle(lambda: 1 / 0, ex, 1)
        assert isinstance(bad.exception(timeout=5), ZeroDivisionError)
        with pytest.raises(ZeroDivisionError):
            bad.block_until_ready()
        with pytest.raises(ZeroDivisionError):
            bad.wait()
    finally:
        ex.shutdown()


def test_async_delivery_block_until_ready_returns_tensor(data_file):
    path, golden = data_file
    with StromContext(StromConfig(engine="python")) as ctx:
        h = ctx.memcpy_ssd2gpu(path, device="cpu", length=1 << 20,
                               async_=True)
        t = h.block_until_ready()
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), golden[:1 << 20])
        assert h._ready == []    # no copy stream on a CPU target
        assert h.exception() is None and h.elapsed_s > 0
        assert h.result() is t
