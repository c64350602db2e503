"""The port's ResNet against the JAX package's on the CPU, with the same
numpy weights through ``params_from_jax``: logits, the new batch-norm state
and the loss at ``ResNetConfig.tiny()`` on an even and an odd input size
(XLA's SAME padding is asymmetric for stride 2, and differently so on the
two), in training and in eval; the parameters after one SGD step against
``strom/cli.py``'s step, rebuilt here from ``strom.models.resnet``; and
ResNet-50's parameter shapes.

Tolerances. f32: both sides compute the same f32 expression and differ
only in the order of f32 sums (batch statistics over B·H·W elements, the
convolutions' dot products), a few ulps, so 1e-5 of the largest value.
bf16: activations are rounded to bf16 after every convolution and batch
norm; where the two sides' f32 sums differ by an ulp before that rounding,
an element lands one bf16 ulp (2^-8 relative) away and the difference
travels on through the layers: 3e-2 of the largest logit, and 1e-2 for the
batch statistics, which average over many such elements. After a bf16
SGD step the parameters move by lr·g, where g sums bf16 terms over B·H·W:
measured on this input, the JAX package's own bf16 step is 0.1-25 % (in
norm) from its f32 step for the f32 batch-norm and head parameters, so the
two bf16 updates of those are held to 50 % of the update's norm; a bf16
weight to one bf16 ulp (2^-7 relative, either side of a rounding) plus
half of the tensor's largest update."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strom.models import resnet as jr
from strom_torch.models import resnet as tr
from strom_torch.parallel.train import make_resnet_sgd_step

TOL = {"float32": dict(logits=1e-5, state=1e-5, params=1e-5),
       "bfloat16": dict(logits=3e-2, state=1e-2)}


def _cfgs(dtype: str):
    return (dataclasses.replace(jr.ResNetConfig.tiny(), dtype=dtype),
            dataclasses.replace(tr.ResNetConfig.tiny(), dtype=dtype))


def _model(jcfg, tcfg, seed=0):
    params, state = jr.init_params(jax.random.key(seed), jcfg)
    model = tr.ResNet(tcfg, device="cpu")
    model.load_state_dict(tr.params_from_jax(params, state))
    return params, state, model


def _close(got: torch.Tensor, want, frac: float, what: str) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale,
                               err_msg=what)


def _flat_state(state) -> dict:
    """The JAX package's bn-state tree, keyed as the port's buffers."""
    out = {}
    out["stem.bn.mean"], out["stem.bn.var"] = state["stem"]["mean"], state["stem"]["var"]
    si = 0
    while f"stage{si}" in state:
        for bi, s in enumerate(state[f"stage{si}"]):
            for n, v in s.items():
                out[f"stage{si}.{bi}.{n}.mean"] = v["mean"]
                out[f"stage{si}.{bi}.{n}.var"] = v["var"]
        si += 1
    return out


def _images(size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (4, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, size, train):
    jcfg, tcfg = _cfgs(dtype)
    params, state, model = _model(jcfg, tcfg)
    x = _images(size)
    labels = np.array([0, 3, 9, 5], np.int32)
    jlogits, jstate = jr.forward(params, state, jnp.asarray(x), jcfg,
                                 train=train)
    tlogits, tstate = model(torch.from_numpy(x), train=train)
    tol = TOL[dtype]
    assert tlogits.dtype == torch.float32 and tlogits.shape == (4, 10)
    _close(tlogits, jlogits, tol["logits"], "logits")
    want_state = _flat_state(jstate)
    assert set(tstate) == set(want_state)
    for k, v in tstate.items():
        _close(v, want_state[k], tol["state"], k)
    jloss = jr.softmax_xent(jlogits, jnp.asarray(labels))
    tloss = tr.softmax_xent(tlogits, torch.from_numpy(labels))
    _close(tloss, jloss, tol["logits"], "loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_step_matches_cli_step(dtype):
    """One step of the port's make_resnet_sgd_step against strom/cli.py's
    sgd_step (loss_fn, normalize_images, w - 1e-3 g over every parameter,
    labels % num_classes) on the same uint8 images: loss, new batch-norm
    state, and every parameter after the step."""
    jcfg, tcfg = _cfgs(dtype)
    params, state, model = _model(jcfg, tcfg, seed=1)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def sgd_step(p, s, images, labels):
        (loss, new_s), grads = jax.value_and_grad(
            jr.loss_fn, has_aux=True)(p, s, jr.normalize_images(images),
                                      labels, jcfg)
        new_p = jax.tree.map(lambda w, g: w - 1e-3 * g, p, grads)
        return new_p, new_s, loss

    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    labels = np.array([1, 13, 999, 4], np.int32)   # some past num_classes
    jp, js, jloss = sgd_step(params, state, jnp.asarray(images),
                             jnp.asarray(labels) % jcfg.num_classes)
    before = {k: v.float().clone() for k, v in model.state_dict().items()}
    step = make_resnet_sgd_step(tcfg, device="cpu")
    metrics = step(model, torch.from_numpy(images), torch.from_numpy(labels))
    tol = TOL[dtype]
    _close(metrics["loss"], jloss, tol["logits"], "loss")
    assert np.isfinite(float(metrics["grad_norm"]))
    want = tr.params_from_jax(jp, js)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        w = want[k].float()
        if k.endswith((".mean", ".var")):
            _close(v, w.numpy(), tol["state"], k)
        elif dtype == "float32":
            _close(v, w.numpy(), tol["params"], k)
        elif v.dtype == torch.bfloat16:
            step_max = (w - before[k]).abs().max()
            assert ((v.float() - w).abs()
                    <= 2.0 ** -7 * w.abs() + 0.5 * step_max).all(), k
        else:
            update, want_update = v - before[k], w - before[k]
            assert (update - want_update).norm() \
                <= 0.5 * want_update.norm(), k


def test_normalize_images_matches_jax():
    u8 = np.random.default_rng(3).integers(0, 256, (2, 5, 5, 3), np.uint8)
    got = tr.normalize_images(torch.from_numpy(u8))
    want = np.asarray(jr.normalize_images(jnp.asarray(u8)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,k,s", [(224, 7, 2), (112, 3, 2), (56, 3, 2),
                                   (33, 3, 2), (17, 1, 2), (14, 3, 1)])
def test_same_padding_matches_xla(n, k, s):
    """conv_same against lax.conv_general_dilated(padding="SAME") on one
    channel: stride 2 pads (2, 3) for 7×7 on 224 and (0, 1) for 3×3 on an
    even size."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((1, n, n, 1)).astype(np.float32)
    w = rng.standard_normal((k, k, 1, 1)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tr.conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    pool = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got_pool = tr.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got_pool.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(pool))


def test_resnet50_shapes_match_jax():
    """Full width: every parameter and buffer of ResNet-50 has the shape the
    JAX package's tree converts to; about 25.6 M parameters."""
    cfg = jr.ResNetConfig.resnet50()
    shapes = jax.eval_shape(lambda k: jr.init_params(k, cfg), jax.random.key(0))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    want = tr.params_from_jax(*zeros)
    model = tr.ResNet(tr.ResNetConfig.resnet50(), device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(a.shape))
                           for a in jax.tree.leaves(shapes[0]))
    assert 25.5e6 < n_params < 25.6e6


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.ResNet(tr.ResNetConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_resnet_sgd_step(tr.ResNetConfig.tiny())
