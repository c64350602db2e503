"""The port's snapshot-then-commit checkpoints, the cases of
``tests/test_ckpt_async.py`` on the CPU: a commit equal to the blocking
save's (and to the JAX package's bytes), snapshot isolation from in-place
mutation (a numpy leaf, and a tensor leaf: torch tensors are mutable), the
step token riding the manifest, back-pressure, the failure latch with the
previous checkpoint intact, flaky writes that never corrupt the last
commit, and the recovery helpers."""

import errno
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strom import ckpt as jckpt
from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom_torch.ckpt import (AsyncCheckpointer, CkptAsyncError, CkptError,
                              clean_orphans, last_committed,
                              restore_checkpoint, save_checkpoint,
                              save_checkpoint_async)
from strom_torch.ckpt.jobstate import (TOKEN_KEY, StepToken,
                                       capture_warm_state, restore_warm_state,
                                       set_resume_gauges)
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.engine.base import Completion
from strom_torch.engine.python_engine import PythonEngine
from strom_torch.pipelines.sampler import SamplerState


def _cfg(**kw) -> StromConfig:
    return StromConfig(engine="python", queue_depth=8, num_buffers=16, **kw)


@pytest.fixture()
def ctx():
    c = StromContext(_cfg())
    yield c
    c.close()


def _state(n=1 << 16):
    return {"w": torch.arange(n, dtype=torch.float32),
            "b": torch.ones((257,), dtype=torch.bfloat16),
            "step": np.array(3, dtype=np.int64)}


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_commit_matches_the_blocking_save(ctx, tmp_path):
    state = _state()
    d, ds = str(tmp_path / "ckpt"), str(tmp_path / "sync")
    commits0 = ctx.scope.counter("ckpt_async_commits").value
    with AsyncCheckpointer(ctx, d) as cp:
        assert cp.last_committed() is None
        cp.save(state)
        m = cp.wait()
        assert cp.last_committed() == os.path.abspath(d)
    assert m == save_checkpoint(ctx, ds, state)
    for name in ("data.bin", "manifest.json"):
        assert open(os.path.join(d, name), "rb").read() \
            == open(os.path.join(ds, name), "rb").read()
    _equal(restore_checkpoint(ctx, d, state, verify=True), state)
    assert ctx.scope.counter("ckpt_async_commits").value - commits0 == 1


def test_commit_bytes_equal_the_reference(ctx, tmp_path):
    state = _state(1 << 12)
    ref = {"w": jnp.arange(1 << 12, dtype=jnp.float32),
           "b": jnp.ones((257,), dtype=jnp.bfloat16),
           "step": np.array(3, dtype=np.int64)}
    jctx = JContext(JConfig(engine="python", queue_depth=8, num_buffers=16,
                            slab_pool_bytes=64 << 20))
    try:
        with jckpt.AsyncCheckpointer(jctx, str(tmp_path / "j")) as cp:
            cp.save(ref)
            cp.wait()
    finally:
        jctx.close()
    save_checkpoint_async(ctx, str(tmp_path / "t"), state).close()
    for name in ("data.bin", "manifest.json"):
        assert open(tmp_path / "t" / name, "rb").read() \
            == open(tmp_path / "j" / name, "rb").read()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_snapshot_isolated_from_mutation(ctx, tmp_path, kind):
    """A leaf changed in place right after save() returns, as a train
    step changes its state, does not reach the checkpoint."""
    buf = np.arange(1 << 16, dtype=np.int64)
    leaf = buf if kind == "numpy" else torch.from_numpy(buf)
    want = buf.copy()
    d = str(tmp_path / "ckpt")
    with AsyncCheckpointer(ctx, d) as cp:
        cp.save({"buf": leaf})
        leaf[:] = -1
        cp.wait()
    got = restore_checkpoint(ctx, d, {"buf": torch.from_numpy(want)},
                             verify=True)
    np.testing.assert_array_equal(got["buf"].numpy(), want)


def test_token_rides_the_manifest(ctx, tmp_path):
    tok = StepToken(sampler=SamplerState(epoch=2, batch_in_epoch=5, seed=7),
                    consumed=21, prefetch_depth=3)
    d = str(tmp_path / "ckpt")
    with AsyncCheckpointer(ctx, d) as cp:
        cp.save(_state(1 << 10), extra={TOKEN_KEY: tok.to_dict()})
        cp.wait()
    got = StepToken.from_manifest(last_committed(d)[1])
    assert got == tok
    p = str(tmp_path / "tok.json")
    tok.save(p)
    assert StepToken.load(p) == tok
    assert StepToken.from_manifest({"extra": {}}) is None


def test_backpressure_one_commit_in_flight(ctx, tmp_path):
    state = _state(1 << 18)
    with AsyncCheckpointer(ctx, str(tmp_path / "ckpt")) as cp:
        cp.save(state)
        cp.save(state)
        assert cp.wait()["payload_bytes"] > 0
        assert cp.commits == 2 and not cp.in_flight
        st = cp.stats()
    assert st["ckpt_async_saves"] == 2 and st["ckpt_async_stall_mean_us"] > 0
    assert len(cp.stalls_us) == 2


def _dying(ctx, monkeypatch):
    def dying(chunks, src):
        raise OSError("injected writer death")

    monkeypatch.setattr(ctx, "write_chunks", dying)


def test_failed_commit_keeps_the_old_checkpoint_and_raises_on_wait(
        ctx, tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    state = _state(1 << 14)
    save_checkpoint(ctx, d, state, extra={TOKEN_KEY: StepToken(
        sampler=SamplerState(seed=1), consumed=4).to_dict()})
    _dying(ctx, monkeypatch)
    cp = AsyncCheckpointer(ctx, d)
    cp.save(dict(state, w=state["w"] + 1))
    with pytest.raises(CkptAsyncError, match="previous checkpoint is intact"):
        cp.wait()
    assert cp.error is None and cp.failures == 1
    assert StepToken.from_manifest(last_committed(d)[1]).consumed == 4
    cp.close(wait=False)
    monkeypatch.undo()
    clean_orphans(d)
    _equal(restore_checkpoint(ctx, d, state, verify=True), state)


def test_failed_commit_raises_on_the_next_save(ctx, tmp_path, monkeypatch):
    _dying(ctx, monkeypatch)
    cp = AsyncCheckpointer(ctx, str(tmp_path / "ckpt"))
    cp.save(_state(1 << 12))
    with pytest.raises(CkptAsyncError):
        cp.save(_state(1 << 12))
    cp.close(wait=False)
    with pytest.raises(CkptError, match="closed"):
        cp.save(_state(1 << 12))


class _FlakyWrites(PythonEngine):
    """Every seventh write op fails, short or with EIO in turn; a piece
    fails once at most, so the retries always recover it."""

    def __init__(self, config):
        super().__init__(config)
        self._n = 0
        self._failed: set = set()
        self._n_lock = threading.Lock()
        self.injected = 0

    def _write(self, req, f, view, direct):
        with self._n_lock:
            self._n += 1
            fire = self._n % 7 == 0 and (req.file_index, req.offset) \
                not in self._failed
            if fire:
                self._failed.add((req.file_index, req.offset))
                self.injected += 1
            short = self._n % 2
        if not fire:
            return super()._write(req, f, view, direct)
        if short:
            os.pwritev(f.fd_buffered, [view[: req.length // 2]], req.offset)
            self._done_q.put(Completion(req.tag, req.length // 2))
        else:
            self._done_q.put(Completion(req.tag, -errno.EIO))


def test_flaky_writes_never_corrupt_the_last_commit(tmp_path):
    """Transient write failures during async commits are absorbed by the
    retries: every commit that reports success restores CRC-checked and
    exact, and a committed checkpoint is always there between saves."""
    cfg = _cfg(io_retries=3)
    ctx = StromContext(cfg, engine=_FlakyWrites(cfg))
    d = str(tmp_path / "ckpt")
    try:
        with AsyncCheckpointer(ctx, d) as cp:
            for i in range(3):
                state = {"w": torch.full((1 << 19,), float(i)),
                         "i": np.array(i)}
                cp.save(state, extra={"i": i})
                assert cp.wait()["extra"]["i"] == i
                assert last_committed(d) is not None
                _equal(restore_checkpoint(ctx, d, state, verify=True), state)
        assert ctx.engine.injected > 0
    finally:
        ctx.close()


def test_recovery_helpers(ctx, tmp_path):
    d = str(tmp_path / "ckpt")
    assert last_committed(d) is None
    save_checkpoint(ctx, d, _state(1 << 10))
    os.rename(d, d + ".old-4242")          # killed between the renames
    assert last_committed(d)[0] == os.path.abspath(d)
    os.makedirs(d + ".tmp-1")
    assert clean_orphans(d) == [os.path.abspath(d) + ".tmp-1"]
    assert os.path.isdir(d)


def test_warm_state_and_gauges(tmp_path):
    """Warm hints of the hot cache replay through ctx.warm on a fresh
    context; the resume verdict's numbers land in the stats registry as
    gauges, through the context's scope."""
    path = str(tmp_path / "f.bin")
    np.random.default_rng(3).integers(0, 256, 1 << 20,
                                      dtype=np.uint8).tofile(path)
    cfg = _cfg(hot_cache_bytes=8 << 20, hot_cache_admit="always")
    with StromContext(_cfg()) as ctx:
        assert capture_warm_state(ctx) is None
    with StromContext(cfg) as ctx:
        ctx.pread(path, 0, 1 << 19)
        warm = capture_warm_state(ctx)
        assert warm["cache"] and warm["cache"][0][0] == path
    with StromContext(cfg) as ctx:
        assert restore_warm_state(ctx, warm) == 1 << 19
        assert restore_warm_state(ctx, None) == 0
        set_resume_gauges({"resume_ok": True, "resume_kill_step": 7,
                           "resume_wall_s": 1.5, "other": 9}, ctx.scope)
        st = ctx.scope.snapshot()
        assert (st["resume_ok"], st["resume_kill_step"],
                st["resume_wall_s"]) == (1, 7, 1.5)
        assert "other" not in st
