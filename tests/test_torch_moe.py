"""The PyTorch port's MoE model (``strom_torch/models/moe.py``) against the
JAX package's (``strom/models/moe.py``) on the CPU, in one process, on
``MoEConfig.tiny()`` in f32 with the JAX package's parameters
(``init_params`` through ``params_from_jax``):

- ``switch_route``: dispatch exactly, combine and the aux losses within
  1e-6, with and without dropped tokens; the reference's three routing
  tests (``tests/test_moe.py``) repeated on the port;
- ``moe_ffn`` (the port's scatter dispatch) against the reference's
  one-hot einsums: output and aux at 1e-5;
- logits and aux losses of ``forward`` within rtol 1e-5, atol 1e-5, with
  and without remat;
- the gradient of ``next_token_loss`` (``jax.grad`` against ``backward``)
  within rtol 1e-4, atol 1e-6, with attention dense and flash (the port's
  plain version on the CPU, the JAX package's Pallas kernels in interpret
  mode) and capacity factors 1.25 and 0.5 (many tokens dropped). The
  smallest gap between a token's two largest router logits, over every
  layer's tokens, exceeds 1e-4: no token's route sits within the
  tolerance of a flip;
- the parameter shapes, and ``moe_param_specs`` against the JAX
  package's rules.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strom.models import moe as jmoe
from strom_torch.models import moe as tmoe
from strom_torch.ops.flash_attention import make_flash_attention

B, S, BLOCK = 2, 64, 32
TOL_ROUTE = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ROUTE_GAP = 1e-4


def _cfgs(capacity_factor: float = 1.25):
    base = dataclasses.replace(jmoe.MoEConfig.tiny().base, dtype="float32")
    jcfg = dataclasses.replace(jmoe.MoEConfig.tiny(), base=base,
                               capacity_factor=capacity_factor)
    tbase = tmoe.LlamaConfig(**base.__dict__)
    tcfg = tmoe.MoEConfig(**{**jcfg.__dict__, "base": tbase})
    return jcfg, tcfg


def _setup(capacity_factor: float = 1.25, seed: int = 0):
    jcfg, tcfg = _cfgs(capacity_factor)
    jparams = jmoe.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tmoe.MoE(tcfg, device="cpu")
    model.load_state_dict(tmoe.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    tokens = np.random.default_rng(seed).integers(0, tcfg.base.vocab, (B, S),
                                                  dtype=np.int32)
    return jcfg, jparams, model, tokens


def _route_inputs(n: int = 64, d: int = 16, e: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(d, e)).astype(np.float32))


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("capacity", [32, 10, 3])
def test_switch_route_matches_reference(capacity):
    h, router = _route_inputs()
    jd, jc, ja = jmoe.switch_route(jnp.asarray(h), jnp.asarray(router),
                                   capacity)
    td, tc, ta = tmoe.switch_route(torch.from_numpy(h),
                                   torch.from_numpy(router), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL_ROUTE,
                               atol=TOL_ROUTE)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=TOL_ROUTE,
                               atol=TOL_ROUTE)


def test_dispatch_combine_shapes_and_mass():
    h, router = _route_inputs(seed=0)
    dispatch, combine, aux = tmoe.switch_route(
        torch.from_numpy(h), torch.from_numpy(router), 32)
    assert dispatch.shape == (64, 4, 32)
    assert set(dispatch.sum((1, 2)).tolist()) <= {0.0, 1.0}
    assert float(dispatch.sum(0).max()) <= 1.0
    assert float(combine.sum()) <= 64.0
    assert torch.isfinite(aux).all()


def test_capacity_drops_overflow():
    h = torch.ones(16, 4)
    router = torch.zeros(4, 2)
    router[:, 0] = 10.0
    dispatch, _, _ = tmoe.switch_route(h, router, 5)
    assert float(dispatch.sum()) == 5.0


def test_balanced_router_keeps_everything():
    h, router = _route_inputs(d=16, e=8, seed=1)
    dispatch, _, _ = tmoe.switch_route(torch.from_numpy(h),
                                       torch.from_numpy(router), 64)
    assert float(dispatch.sum()) == 64.0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(capacity_factor):
    """The scatter dispatch into [E, C_buf, d] against the reference's
    one-hot einsums, on layer 0's parameters."""
    jcfg, jparams, model, _ = _setup(capacity_factor, seed=4)
    h = np.random.default_rng(5).normal(size=(B, S, 128)).astype(np.float32)
    lp = {k: v[0] for k, v in jparams["layers"].items()}
    want, want_aux = jmoe.moe_ffn(jnp.asarray(h), lp, jcfg)
    with torch.no_grad():
        got, aux = tmoe.moe_ffn(torch.from_numpy(h), {
            n: getattr(model, n)[0] for n in tmoe.LAYER_PARAMS}, model.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-5,
                               atol=1e-5)


# -------------------------------------------------------------- forward
@pytest.mark.parametrize("remat", [False, True])
def test_logits_and_aux_match_f32(remat):
    jcfg, jparams, model, tokens = _setup(seed=1)
    want, want_aux = jmoe.forward(jparams, jnp.asarray(tokens), jcfg,
                                  remat=remat)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tokens), remat=remat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-5,
                               atol=1e-5)


def _router_gap(model, tokens: np.ndarray, attn_fn) -> float:
    """The smallest top-1/top-2 router-logit gap over every layer's
    tokens of the port's forward."""
    gaps = []
    route = tmoe.route

    def recording(hf, router, *a, **kw):
        r = route(hf, router, *a, **kw)
        top = torch.topk(r.logits, 2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        return r

    tmoe.route = recording
    try:
        with torch.no_grad():
            model(torch.from_numpy(tokens), attn_fn=attn_fn)
    finally:
        tmoe.route = route
    assert len(gaps) == model.cfg.base.n_layers
    return min(gaps)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_grads_match_jax(attn, capacity_factor):
    from strom.ops.flash_attention import make_flash_attention as jflash

    jcfg, jparams, model, tokens = _setup(capacity_factor, seed=2)
    j_attn = jflash(block_q=BLOCK, block_k=BLOCK) if attn == "flash" else None
    t_attn = make_flash_attention(block_q=BLOCK, block_k=BLOCK) \
        if attn == "flash" else None
    want_loss, want = jax.value_and_grad(jmoe.next_token_loss)(
        jparams, jnp.asarray(tokens), jcfg, attn_fn=j_attn, remat=True)
    loss = tmoe.next_token_loss(model, torch.from_numpy(tokens),
                                attn_fn=t_attn, remat=True)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= GRAD_RTOL * abs(
        float(want_loss))
    flat = {k: v for k, v in want.items() if k != "layers"}
    flat.update(want["layers"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(flat[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert _router_gap(model, tokens, t_attn) > ROUTE_GAP


def test_capacity_half_drops_tokens():
    """The 0.5 cases above route with drops: a layer keeps fewer tokens
    than the batch holds."""
    _, _, model, tokens = _setup(0.5, seed=2)
    routes = []
    with torch.no_grad():
        model(torch.from_numpy(tokens), routes=routes)
    assert len(routes) == model.cfg.base.n_layers
    for expert, keep in routes:
        assert 0 < int(keep.sum()) < B * S
        assert int(keep.sum()) <= model.cfg.capacity(B * S) * 4


# -------------------------------------------------------- shapes, rules
def test_param_shapes_and_specs_match_reference():
    from strom.parallel import sharding as jsharding
    from strom_torch.parallel import sharding as tsharding

    for jcfg, tcfg in [(jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()),
                       (jmoe.MoEConfig(base=jmoe.LlamaConfig.llama3_8b()),
                        tmoe.MoEConfig(base=tmoe.LlamaConfig.llama3_8b()))]:
        shapes = jax.eval_shape(lambda: jmoe.init_params(
            jax.random.PRNGKey(0), jcfg))
        flat = {k: v.shape for k, v in shapes.items() if k != "layers"}
        flat.update({k: v.shape for k, v in shapes["layers"].items()})
        assert flat == tmoe.param_shapes(tcfg)
    specs = jsharding.moe_param_specs(shapes)
    jflat = {k: tuple(v) for k, v in specs.items() if k != "layers"}
    jflat.update({k: tuple(v) for k, v in specs["layers"].items()})
    got = tsharding.moe_param_specs(tmoe.param_shapes(tcfg))
    assert {k: tuple(v) for k, v in got.items()} == jflat
    assert got["w_gate"] == tsharding.P("pp", "ep", None, "tp")


def test_router_stays_f32_in_bf16():
    model = tmoe.MoE(tmoe.MoEConfig.tiny(), device="cpu")
    assert model.router.dtype == torch.float32
    assert model.w_gate.dtype == torch.bfloat16
    logits, aux = model(torch.zeros(1, 8, dtype=torch.int64))
    assert logits.dtype == torch.float32 and torch.isfinite(aux).all()
