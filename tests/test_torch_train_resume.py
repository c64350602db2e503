"""Resume a train run from a ``TrainCheckpointer`` checkpoint on the CPU: a
tiny Llama (flash attention's plain route, fused AdamW) takes 4 steps
uninterrupted, and 2 steps, a save, a fresh state and a fresh pipeline
restored from it, then 2 steps; the losses, grad norms and every tensor of
the final state are equal bit for bit, for blocking and async saves."""

import os

import numpy as np
import pytest
import torch

from strom_torch.ckpt.checkpoint import tree_flatten
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.formats.rawbin import write_token_shard
from strom_torch.models.llama import LlamaConfig
from strom_torch.parallel.train import (init_train_state, load_train_state,
                                        make_train_step, train_state_tree)
from strom_torch.pipelines import make_llama_pipeline
from strom_torch.pipelines.checkpoint import TrainCheckpointer

SEQ = 32
B = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    td = tmp_path_factory.mktemp("resume")
    cfg = LlamaConfig.tiny()
    ctx = StromContext(StromConfig(engine="python", queue_depth=8,
                                   num_buffers=8))
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        p = str(td / f"tok{i}.bin")
        write_token_shard(ctx, p, rng.integers(0, cfg.vocab, 7 * (SEQ + 1),
                                               dtype=np.int32))
        paths.append(p)
    step = make_train_step(cfg, attn="flash", device="cpu")
    yield cfg, ctx, paths, step
    ctx.close()


def _pipe(ctx, paths, **kw):
    return make_llama_pipeline(ctx, paths, batch=B, seq_len=SEQ,
                               device="cpu", seed=5, prefetch_depth=1, **kw)


def _steps(step, state, pipe, n):
    out = []
    for _ in range(n):
        state, m = step(state, next(pipe))
        out.append((m["loss"], m["grad_norm"]))
    return state, out


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _leaves_equal(s1, s2) -> list[int]:
    l1, t1 = tree_flatten(train_state_tree(s1))
    l2, t2 = tree_flatten(train_state_tree(s2))
    assert t1 == t2
    return [i for i, (a, b) in enumerate(zip(l1, l2))
            if not (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)]


@pytest.fixture(scope="module")
def uninterrupted(setup):
    cfg, ctx, paths, step = setup
    state = init_train_state(cfg, device="cpu", seed=0)
    with _pipe(ctx, paths) as pipe:
        state, metrics = _steps(step, state, pipe, 4)
    return state, metrics


@pytest.mark.parametrize("blocking", [True, False])
def test_resume_is_bit_exact(setup, uninterrupted, tmp_path, blocking):
    cfg, ctx, paths, step = setup
    want_state, want = uninterrupted
    ck = TrainCheckpointer(str(tmp_path / "ckpts"), ctx)
    state = init_train_state(cfg, device="cpu", seed=0)
    with _pipe(ctx, paths) as pipe:
        state, first = _steps(step, state, pipe, 2)
        ck.save(2, train_state_tree(state), pipe, {"note": "mid"},
                blocking=blocking)
        # the state moves on while an async save commits; the checkpoint
        # keeps step 2
        state, _ = _steps(step, state, pipe, 1)
    ck.wait_until_finished()
    assert ck.latest_step() == 2
    assert _same([m for pair in first for m in pair],
                 [m for pair in want[:2] for m in pair])

    fresh = init_train_state(cfg, device="cpu", seed=9)
    tree, sampler_state, extra = ck.restore(2, train_state_tree(fresh))
    assert extra == {"note": "mid"} and sampler_state.batch_in_epoch == 2
    load_train_state(fresh, tree)
    assert fresh.step == 2 and fresh.scheduler.last_epoch == 2
    with _pipe(ctx, paths, resume_from=ck.loader_state_path(2)) as pipe:
        fresh, got = _steps(step, fresh, pipe, 2)
    assert _same([m for pair in got for m in pair],
                 [m for pair in want[2:] for m in pair]), (got, want[2:])
    assert _leaves_equal(fresh, want_state) == []
    ck.close()


def test_resume_against_a_changed_dataset_raises(setup, tmp_path):
    cfg, ctx, paths, step = setup
    ck = TrainCheckpointer(str(tmp_path / "ckpts"), ctx)
    state = init_train_state(cfg, device="cpu", seed=0)
    with _pipe(ctx, paths) as pipe:
        ck.save(0, train_state_tree(state), pipe)
    with pytest.raises(ValueError, match="different dataset"):
        _pipe(ctx, paths[:1], resume_from=ck.loader_state_path(0))


def test_latest_step_ignores_incomplete(setup, tmp_path, monkeypatch):
    """A save whose state commit fails writes no loader blob: the step is
    not complete and latest_step skips it; the failure raises at the next
    join."""
    cfg, ctx, paths, step = setup
    ck = TrainCheckpointer(str(tmp_path / "ckpts"), ctx)
    state = init_train_state(cfg, device="cpu", seed=0)
    with _pipe(ctx, paths) as pipe:
        ck.save(1, train_state_tree(state), pipe)

        def dying(chunks, src):
            raise OSError("writer died")

        monkeypatch.setattr(ctx, "write_chunks", dying)
        ck.save(3, train_state_tree(state), pipe, blocking=False)
        with pytest.raises(RuntimeError, match="commit failed"):
            ck.wait_until_finished()
        monkeypatch.undo()
    assert os.path.isdir(os.path.join(ck.root, "00000003"))
    assert ck.latest_step() == 1


def test_load_train_state_creates_the_optimizer_state(setup):
    """A state that has not stepped gets AdamW's own first state (zero
    moments, step 0): stepping it equals stepping one left to AdamW."""
    cfg, _, _, step = setup
    a = init_train_state(cfg, device="cpu", seed=0)
    b = init_train_state(cfg, device="cpu", seed=0)
    load_train_state(b, train_state_tree(
        init_train_state(cfg, device="cpu", seed=0)))
    assert len(b.optimizer.state) == len(list(b.model.parameters()))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, SEQ + 1), dtype=np.int32))
    a, ma = step(a, tokens)
    b, mb = step(b, tokens)
    assert torch.equal(ma["loss"], mb["loss"])
    assert _leaves_equal(a, b) == []
