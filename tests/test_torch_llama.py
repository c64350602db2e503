"""The PyTorch port's Llama against the JAX reference on the CPU: the same
parameters (``init_params`` taken to numpy through ``params_from_jax``) and
the same tokens give the same logits and loss."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strom.models import llama as jllama
from strom_torch.models import llama as tllama
from strom_torch.ops.flash_attention import make_flash_attention


def _setup(cfg_kwargs=None, seed=0, B=2, S=64):
    jcfg = jllama.LlamaConfig(**{**jllama.LlamaConfig.tiny().__dict__,
                                 "dtype": "float32", **(cfg_kwargs or {})})
    tcfg = tllama.LlamaConfig(**jcfg.__dict__)
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(np_params))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, S),
                                                  dtype=np.int32)
    return jcfg, jparams, model, tokens


def test_param_shapes_match_reference():
    for name in ("tiny", "small", "llama3_8b"):
        jcfg = getattr(jllama.LlamaConfig, name)()
        tcfg = getattr(tllama.LlamaConfig, name)()
        shapes = jax.eval_shape(lambda: jllama.init_params(
            jax.random.PRNGKey(0), jcfg))
        flat = {k: v.shape for k, v in shapes.items() if k != "layers"}
        flat.update({k: v.shape for k, v in shapes["layers"].items()})
        assert flat == tllama.param_shapes(tcfg)
        assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("remat", [False, True])
def test_logits_match_f32(remat):
    jcfg, jparams, model, tokens = _setup()
    want = np.asarray(jllama.forward(jparams, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), remat=remat).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_loss_matches_f32():
    jcfg, jparams, model, tokens = _setup(seed=1)
    want = float(jllama.next_token_loss(jparams, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = float(tllama.next_token_loss(model, torch.from_numpy(tokens)))
    assert abs(got - want) < 1e-5, (got, want)


def test_flash_attn_fn_matches_dense_loss():
    """The attn_fn hook: the flash op (plain version on the CPU) gives the
    dense path's loss; head_dim 64 and S 128 so blocks tile."""
    jcfg, jparams, model, tokens = _setup(
        {"d_model": 128, "n_heads": 2, "n_kv_heads": 1}, seed=2, B=1, S=128)
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        dense = float(tllama.next_token_loss(model, t))
        flash = float(tllama.next_token_loss(
            model, t, attn_fn=make_flash_attention(block_q=64, block_k=64),
            remat=True))
    want = float(jllama.next_token_loss(jparams, jnp.asarray(tokens), jcfg))
    assert abs(flash - dense) < 1e-5 and abs(flash - want) < 1e-5


def test_bf16_params_convert_exactly():
    jcfg = jllama.LlamaConfig.tiny()
    np_params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.PRNGKey(3), jcfg))
    sd = tllama.params_from_jax(np_params)
    assert sd["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["wq"].float().numpy(),
                                  np_params["layers"]["wq"].astype(np.float32))
    assert sd["attn_norm"].dtype == torch.float32
