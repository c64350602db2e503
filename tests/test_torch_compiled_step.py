"""The port's train steps as the CUDA graphs need them, on the CPU, where
each step runs its eager body: five Llama steps across the warm-up
boundary of the schedule against the JAX step (the lr is a device tensor
the schedule fills step by step); ``global_norm`` without f32 copies
against ``optax.global_norm``; every tensor a graph captures (parameters,
AdamW moments, batch-norm statistics, the lr) updated in place, at the
same address, by all three steps; ResNet's one-pass batch statistics
against the JAX package's two-pass ones, also where the mean is large
against the spread; ViT's attention with the keys padded to a multiple of
8, against the JAX package's at S 197.

Tolerances are those of ``test_torch_train.py``, ``test_torch_resnet.py``
and ``test_torch_vit.py``, with their reasons: f32 sums in another order.
The one new one, ``global_norm`` of bf16 gradients against optax's: optax
sums each leaf's squares in bf16 and rounds the norm to bf16 (2^-9
relative a rounding; the sum over leaves and the square root add two
more), where the port sums in f32, so 2^-7 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from strom.models import llama as jllama
from strom.models import resnet as jr
from strom.models import vit as jvit
from strom.parallel import train as jtrain
from strom.parallel.mesh import make_mesh
from strom_torch.models import llama as tllama
from strom_torch.models import resnet as tr
from strom_torch.models import vit as tvit
from strom_torch.parallel import train as ttrain

LR, WARMUP = 1e-2, 3


def _tokens(vocab, n, B=2, L=64, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, L), dtype=np.int32) for _ in range(n)]


def test_five_llama_steps_track_jax_across_warmup():
    """Steps 1-3 run at lr 0, 1/3 and 2/3 of the peak, steps 4-5 on the
    cosine: the optimizer's lr tensor is refilled before every step."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jopt = jtrain.make_optimizer(lr=LR, warmup=WARMUP)
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, mesh, jopt)
    params = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jstate.params))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    spec = ttrain.make_optimizer(lr=LR, warmup=WARMUP)
    tstate = ttrain.init_train_state(tcfg, spec, device="cpu", params=params)
    jstep = jtrain.make_train_step(jcfg, mesh, jopt, donate=False)
    tstep = ttrain.make_train_step(tcfg, spec, device="cpu")
    lr = tstate.optimizer.param_groups[0]["lr"]
    lrs = []
    for tokens in _tokens(jcfg.vocab, 5):
        lrs.append(float(lr))
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        tstate, tm = tstep(tstate, torch.from_numpy(tokens))
        jl, jn = float(jm["loss"]), float(jm["grad_norm"])
        assert abs(float(tm["loss"]) - jl) < 1e-4, (len(lrs), tm, jl)
        assert abs(float(tm["grad_norm"]) - jn) <= 1e-4 * max(1.0, jn)
    assert tstate.step == 5 and tstep.last_call == "eager"
    want = [LR * ttrain.warmup_cosine(s, warmup=WARMUP) for s in range(5)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    np.testing.assert_allclose(tstate.model.wq.detach().numpy(),
                               np.asarray(jstate.params["layers"]["wq"]),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (jnp.bfloat16, 2.0 ** -7)])
def test_global_norm_matches_optax(dtype, rtol):
    rng = np.random.default_rng(2)
    grads = [(rng.normal(size=s) * 3).astype(dtype)
             for s in ((64, 33), (7,), (3, 5, 9))]
    got = ttrain.global_norm([torch.from_numpy(g.astype(np.float32)).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
        for g in grads])
    assert got.dtype == torch.float32
    want = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    assert float(got) == pytest.approx(want, rel=rtol)


def _ptrs(tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


def test_llama_step_updates_in_place():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), n_layers=1)
    state = ttrain.init_train_state(cfg, ttrain.make_optimizer(warmup=1),
                                    device="cpu")
    step = ttrain.make_train_step(cfg, device="cpu")
    params = list(state.model.parameters())
    before = [p.detach().clone() for p in params]
    lr = state.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dim() == 0
    want, moments = _ptrs(params), None
    for tokens in _tokens(cfg.vocab, 3, L=32):
        state, _ = step(state, torch.from_numpy(tokens))
        assert _ptrs(params) == want
        now = _ptrs(state.optimizer.state[p][k] for p in params
                    for k in ("exp_avg", "exp_avg_sq", "step"))
        assert moments is None or now == moments
        moments = now
        assert state.optimizer.param_groups[0]["lr"] is lr
    assert float(lr) > 0 and state.step == 3
    assert not all(torch.equal(a, b) for a, b in zip(before, params))


def test_vision_steps_update_in_place():
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), np.uint8))
    labels = torch.from_numpy(rng.integers(0, 1000, 2, dtype=np.int32))
    for make, model in (
            (ttrain.make_resnet_sgd_step,
             tr.ResNet(tr.ResNetConfig.tiny(), device="cpu")),
            (ttrain.make_vit_sgd_step,
             tvit.ViT(tvit.ViTConfig.tiny(), device="cpu",
                      generator=torch.Generator().manual_seed(0)))):
        step = make(model.cfg, device="cpu")
        tensors = [*model.parameters(), *model.buffers()]
        want = _ptrs(tensors)
        before = [t.detach().clone() for t in tensors]
        for _ in range(3):
            assert np.isfinite(step(model, images, labels)["loss"].item())
            assert _ptrs(tensors) == want
        assert not all(torch.equal(a, b) for a, b in zip(before, tensors))


# ------------------------------------------------- ResNet batch statistics
# bf16 cannot hold a spread 3e4 times below the mean (its ulp at 300 is 2)
@pytest.mark.parametrize("dtype,offset,spread", [("float32", 0.0, 1.0),
                                                 ("bfloat16", 0.0, 1.0),
                                                 ("float32", 300.0, 0.01)])
def test_batch_norm_one_pass_matches_jax(dtype, offset, spread):
    """One training batch norm: the new running mean and variance against
    the JAX package's two-pass statistics at test_torch_resnet.py's state
    tolerance, and the output at its logits tolerance. Where the mean is
    3e4 times the spread, a naive one-pass variance, E[x²] − E[x]², would
    be wrong by 50 times the variance in f32: there the batch variance is
    held to the float64 one at 1e-3 relative instead of the output (the JAX
    package's own f32 mean is 1.5e-4 off here, 1.5e-2 of the spread, which
    the normalised output shows)."""
    jcfg = dataclasses.replace(jr.ResNetConfig.tiny(), dtype=dtype)
    tcfg = dataclasses.replace(tr.ResNetConfig.tiny(), dtype=dtype)
    rng = np.random.default_rng(11)
    x = (offset + spread * rng.standard_normal((8, 6, 5, 16))).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    mean0 = rng.normal(size=16).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.jdtype)
    want, new = jr._batch_norm(jx, {"scale": scale, "bias": bias},
                               {"mean": mean0, "var": var0}, jcfg, train=True)
    bn = tr.BatchNorm(16, tcfg, "cpu")
    with torch.no_grad():
        for t, a in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean0),
                     (bn.var, var0)):
            t.copy_(torch.from_numpy(a))
    xs = np.array(jx.astype(jnp.float32))   # the inputs both sides saw
    tx = torch.from_numpy(xs).to(tcfg.torch_dtype).permute(0, 3, 1, 2)
    state: dict = {}
    got = bn(tx, True, state)
    mean, var = state[bn]
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    for name, g, w in (("mean", mean, new["mean"]), ("var", var, new["var"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=name)
    if offset:
        # from zero running statistics the new ones are (1 − m)·batch
        with torch.no_grad():
            bn.mean.zero_()
            bn.var.zero_()
        bn(tx, True, state)
        batch_var = state[bn][1].double().numpy() / (1 - tcfg.bn_momentum)
        np.testing.assert_allclose(batch_var, xs.astype(np.float64).var(
            (0, 1, 2)), rtol=1e-3)
        return
    out_tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).detach().numpy(),
                               w, rtol=0, atol=out_tol * np.abs(w).max())


@pytest.mark.parametrize("low", [0, 250])
def test_resnet_step_running_statistics_match_jax(low):
    """One train step of the tiny ResNet in f32 from uint8 images in
    [low, 255]: the stored running statistics against the JAX loss's new
    state at test_torch_resnet.py's f32 tolerance. Images of 250-255 give
    the stem's batch norm a mean large against its spread."""
    jcfg = dataclasses.replace(jr.ResNetConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tr.ResNetConfig.tiny(), dtype="float32")
    params, state = jr.init_params(jax.random.key(4), jcfg)
    model = tr.ResNet(tcfg, device="cpu")
    model.load_state_dict(tr.params_from_jax(params, state))
    rng = np.random.default_rng(3)
    images = rng.integers(low, 256, (4, 32, 32, 3), dtype=np.uint8)
    labels = np.array([1, 2, 3, 4], np.int32)
    _, jstate = jr.loss_fn(params, state, jr.normalize_images(
        jnp.asarray(images)), jnp.asarray(labels), jcfg)
    ttrain.make_resnet_sgd_step(tcfg, device="cpu")(
        model, torch.from_numpy(images), torch.from_numpy(labels))
    want = tr.params_from_jax(params, jstate)
    got = model.state_dict()
    for k in got:
        if k.endswith((".mean", ".var")):
            w = want[k].numpy()
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(), err_msg=k)


# --------------------------------------------------- ViT padded attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_block_at_197_matches_jax(dtype):
    """One encoder block at ViT-B/16's sequence length, 197 (keys padded
    to 200), against the JAX block on the same weights and activations."""
    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), dtype=dtype)
    tcfg = dataclasses.replace(tvit.ViTConfig.tiny(), dtype=dtype)
    params = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(1), jcfg))
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    x = np.random.default_rng(6).standard_normal((2, 197, jcfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jcfg.jdtype)
    want = np.asarray(jvit._block(jx, lp, jcfg).astype(jnp.float32))
    block = tvit.Block(tcfg, "cpu", torch.Generator().manual_seed(0))
    sd = tvit.params_from_jax(params)
    block.load_state_dict({k[len("layers.0."):]: v for k, v in sd.items()
                           if k.startswith("layers.0.")})
    with torch.no_grad():
        got = block(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            tcfg.torch_dtype)).float().numpy()
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * scale)


@pytest.mark.parametrize("S,pads", [(197, 2), (17, 2), (200, 0), (16, 0)])
def test_vit_attention_pads_only_ragged_keys(monkeypatch, S, pads):
    """Keys and values are padded only where S is not a multiple of 8, and
    the result equals the JAX package's dense attention either way."""
    calls = []
    real_pad = tvit.F.pad

    def counting_pad(*a, **kw):
        calls.append(1)
        return real_pad(*a, **kw)

    monkeypatch.setattr(tvit.F, "pad", counting_pad)
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((2, S, 3, 16)).astype(np.float32)
               for _ in range(3))
    got = tvit.attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert len(calls) == pads
    want = np.asarray(jllama.attention(*(jnp.asarray(t) for t in (q, k, v)),
                                       causal=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_vit_logits_at_197_match_jax():
    """The tiny ViT at 112² with 8² patches: S 197, as ViT-B/16's."""
    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), image_size=112,
                               dtype="float32")
    tcfg = dataclasses.replace(tvit.ViTConfig.tiny(), image_size=112,
                               dtype="float32")
    assert tcfg.n_patches + 1 == 197
    params = jvit.init_params(jax.random.key(2), jcfg)
    model = tvit.ViT(tcfg, device="cpu")
    model.load_state_dict(tvit.params_from_jax(jax.tree.map(np.asarray,
                                                            params)))
    images = np.random.default_rng(8).standard_normal(
        (2, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jvit.forward(params, jnp.asarray(images), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
