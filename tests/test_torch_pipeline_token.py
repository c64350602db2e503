"""A StepToken resumes a pipeline in the port as in the JAX package:
``resolve_state`` takes a token, ``Pipeline.token`` captures the next
unconsumed batch with the prefetch depth and the fingerprint, and
``Pipeline.restore`` takes a token from either package (JSON round trip)
and continues both packages' streams at the same next batch; a token of
another dataset or seed raises ValueError in both."""

import jax
import numpy as np
import pytest
from jax.sharding import SingleDeviceSharding

from strom.ckpt.jobstate import StepToken as JStepToken
from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.pipelines import make_llama_pipeline as j_make_llama_pipeline
from strom.pipelines.base import resolve_state as j_resolve_state
from strom.pipelines.sampler import SamplerState as JSamplerState
from strom_torch.ckpt.jobstate import StepToken
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.formats.rawbin import write_token_shard
from strom_torch.pipelines.base import resolve_state
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline
from strom_torch.pipelines.sampler import SamplerState

SEQ = 15


@pytest.fixture()
def shards(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    with StromContext(StromConfig(engine="python")) as ctx:
        for i, n in enumerate((16, 12)):
            p = str(tmp_path / f"tok{i}.bin")
            write_token_shard(ctx, p, rng.integers(0, 1000, n * (SEQ + 1),
                                                   dtype=np.int32))
            paths.append(p)
    return paths


def test_resolve_state_takes_a_step_token(tmp_path):
    """The reproduction: a 16 KiB shard, a token at batch 3 of epoch 0."""
    shard = tmp_path / "shard.bin"
    shard.write_bytes(np.arange(4096, dtype=np.int32).tobytes())
    want = SamplerState(epoch=0, batch_in_epoch=3, seed=0)
    st, fp = resolve_state((str(shard),), seed=0, resume_from=StepToken(
        sampler=SamplerState(epoch=0, batch_in_epoch=3, seed=0)))
    jst, jfp = j_resolve_state((str(shard),), seed=0, resume_from=JStepToken(
        sampler=JSamplerState(epoch=0, batch_in_epoch=3, seed=0)))
    assert st == want and jst.to_dict() == st.to_dict() and fp == jfp
    with pytest.raises(ValueError, match="seed"):
        resolve_state((str(shard),), seed=1, resume_from=StepToken(
            sampler=want))
    with pytest.raises(ValueError, match="different dataset"):
        resolve_state((str(shard),), seed=0, resume_from=StepToken(
            sampler=want, fingerprint={"paths": ["x", "y"],
                                       "sizes": [1, 2]}))


def _pipes(tctx, jctx, shards, **kw):
    kw = dict(batch=3, seq_len=SEQ, seed=2, prefetch_depth=2, **kw)
    sharding = SingleDeviceSharding(jax.devices()[0])
    return (make_llama_pipeline(tctx, shards, device="cpu", **kw),
            j_make_llama_pipeline(jctx, shards, sharding=sharding, **kw))


@pytest.mark.parametrize("source", ["port", "jax_package"])
def test_token_roundtrip_resumes_both_to_the_same_batch(source, shards):
    tctx = StromContext(StromConfig(engine="python", queue_depth=4,
                                    num_buffers=4))
    jctx = JContext(JConfig(engine="python", queue_depth=4, num_buffers=4))
    try:
        tp, jp = _pipes(tctx, jctx, shards)
        with tp, jp:
            for _ in range(11):    # 9 batches an epoch: into epoch 1
                np.testing.assert_array_equal(next(tp).numpy(),
                                              np.asarray(next(jp)))
            ttok, jtok = tp.token(tctx), jp.token(jctx)
            assert ttok.to_dict() == jtok.to_dict()
            assert ttok.sampler == SamplerState(epoch=1, batch_in_epoch=2,
                                                seed=2)
            assert (ttok.consumed, ttok.prefetch_depth) == (11, 2)
            want = [np.asarray(next(jp)) for _ in range(4)]
        doc = (ttok if source == "port" else jtok).to_dict()
        tp2, jp2 = _pipes(tctx, jctx, shards)
        with tp2, jp2:
            # fresh pipelines at batch 0, moved to the token's position
            tp2.restore(StepToken.from_dict(doc))
            jp2.restore(JStepToken.from_dict(doc))
            for w in want:
                np.testing.assert_array_equal(next(tp2).numpy(), w)
                np.testing.assert_array_equal(np.asarray(next(jp2)), w)
        # a factory given the token starts there too, and restore keeps
        # its window (already positioned)
        tp3, _ = _pipes(tctx, jctx, shards,
                        resume_from=StepToken.from_dict(doc))
        with tp3:
            win = tp3._prefetcher
            assert tp3.restore(StepToken.from_dict(doc)) is tp3
            assert tp3._prefetcher is win
            np.testing.assert_array_equal(next(tp3).numpy(), want[0])
    finally:
        tctx.close()
        jctx.close()


def test_restore_adopts_the_token_depth(shards):
    with StromContext(StromConfig(engine="python")) as ctx:
        with make_llama_pipeline(ctx, shards, batch=3, seq_len=SEQ, seed=2,
                                 device="cpu", prefetch_depth=1) as p:
            next(p)
            tok = p.token(extra={"k": 1})
            tok.prefetch_depth = 3
            p.restore(tok)
            assert p.prefetch_depth == 3 and tok.extra == {"k": 1}
            assert p.token().consumed == 1


@pytest.mark.parametrize("pkg", ["port", "jax_package"])
def test_mismatched_token_raises(pkg, shards):
    if pkg == "port":
        ctx = StromContext(StromConfig(engine="python"))
        pipe = make_llama_pipeline(ctx, shards, batch=3, seq_len=SEQ, seed=2,
                                   device="cpu")
        Tok, St = StepToken, SamplerState
    else:
        ctx = JContext(JConfig(engine="python"))
        pipe = j_make_llama_pipeline(
            ctx, shards, batch=3, seq_len=SEQ, seed=2,
            sharding=SingleDeviceSharding(jax.devices()[0]))
        Tok, St = JStepToken, JSamplerState
    try:
        with pipe:
            other = Tok(sampler=St(epoch=0, batch_in_epoch=1, seed=2),
                        fingerprint={"paths": shards[:1], "sizes": [1]})
            with pytest.raises(ValueError, match="different dataset"):
                pipe.restore(other)
            with pytest.raises(ValueError, match="seed"):
                pipe.restore(Tok(sampler=St(epoch=0, batch_in_epoch=1,
                                            seed=9)))
            with pytest.raises(ValueError, match="seed"):
                pipe.restore(St(epoch=0, batch_in_epoch=1, seed=9))
    finally:
        ctx.close()
