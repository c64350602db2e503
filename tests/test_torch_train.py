"""The PyTorch port's train step against the JAX reference on the CPU: from
identical parameters (``init_params`` taken to numpy) and identical token
batches, three steps of ``make_train_step`` track the JAX step's loss and
grad_norm at f32, through the optax chain the port reproduces (clip by
global norm 1.0, AdamW on a warmup-cosine schedule whose first update has
lr 0). ``warmup=2`` makes lr non-zero from the second update, so steps 2
and 3 test the optimizer, not only the forward."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from strom.models import llama as jllama
from strom.parallel import train as jtrain
from strom.parallel.mesh import make_mesh
from strom_torch.models import llama as tllama
from strom_torch.parallel import train as ttrain

LR, WARMUP = 1e-2, 2


def _tiny_f32(**kw):
    return dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32", **kw)


def _batches(cfg, n, B=2, L=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (B, L), dtype=np.int32) for _ in range(n)]


def _run_both(jcfg, attn, batches):
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jopt = jtrain.make_optimizer(lr=LR, warmup=WARMUP)
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, mesh, jopt)
    params = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jstate.params))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    tstate = ttrain.init_train_state(
        tcfg, ttrain.make_optimizer(lr=LR, warmup=WARMUP), device="cpu",
        params=params)
    jstep = jtrain.make_train_step(jcfg, mesh, jopt, attn=attn, donate=False)
    tstep = ttrain.make_train_step(tcfg, ttrain.make_optimizer(lr=LR,
                                                               warmup=WARMUP),
                                   attn=attn, device="cpu")
    out = []
    for tokens in batches:
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        tstate, tm = tstep(tstate, torch.from_numpy(tokens))
        out.append((float(jm["loss"]), float(jm["grad_norm"]),
                    float(tm["loss"]), float(tm["grad_norm"])))
    return out, jstate, tstate


@pytest.mark.parametrize("attn,cfg_kw,L", [
    ("dense", {}, 64),
    # head dim 64 and 128 tokens: the flash blocks tile as on the card
    ("flash", {"d_model": 128, "n_heads": 2, "n_kv_heads": 1}, 128),
])
def test_three_steps_track_jax(attn, cfg_kw, L):
    jcfg = _tiny_f32(**cfg_kw)
    curve, jstate, tstate = _run_both(jcfg, attn, _batches(jcfg, 3, L=L))
    for i, (jl, jn, tl, tn) in enumerate(curve):
        assert abs(tl - jl) < 1e-4, (i, tl, jl)
        assert abs(tn - jn) <= 1e-4 * max(1.0, jn), (i, tn, jn)
    # the updates moved the weights the same way
    jw = np.asarray(jstate.params["layers"]["wq"])
    tw = tstate.model.wq.detach().numpy()
    assert not np.allclose(jw, np.asarray(
        jllama.init_params(jax.random.PRNGKey(0), jcfg)["layers"]["wq"]))
    np.testing.assert_allclose(tw, jw, rtol=1e-3, atol=1e-5)


def test_schedule_matches_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 1.0, 100, 10_000, 0.1)
    for s in (0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 12_000):
        assert ttrain.warmup_cosine(s, warmup=100) == pytest.approx(
            float(sched(s)), rel=1e-5, abs=1e-7), s


def test_clip_matches_optax():
    """clip-by-global-norm 1.0 applied in place, as optax's chain does."""
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) * 3 for s in ((4, 5), (7,))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    norm = ttrain.global_norm([torch.from_numpy(g) for g in grads])
    assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
    got = [torch.from_numpy(g) * torch.clamp(1.0 / norm, max=1.0) for g in grads]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_adamw_state_in_param_dtype():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), n_layers=1)
    state = ttrain.init_train_state(cfg, device="cpu", seed=0)
    step = ttrain.make_train_step(cfg, device="cpu")
    state, m = step(state, torch.from_numpy(_batches(cfg, 1, L=32)[0]))
    assert np.isfinite(float(m["loss"])) and state.step == 1
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        assert st["exp_avg"].dtype == p.dtype == st["exp_avg_sq"].dtype
    assert state.model.wq.dtype == torch.bfloat16
    assert state.model.attn_norm.dtype == torch.float32


def test_bad_attn_rejected():
    with pytest.raises(ValueError, match="attn"):
        ttrain.make_train_step(tllama.LlamaConfig.tiny(), attn="ring",
                               device="cpu")
