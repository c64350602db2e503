"""The port's ViT against the JAX package's on the CPU, with the same numpy
weights through ``params_from_jax``: logits of ``ViTConfig.tiny()`` in f32
and bf16, one ``make_vit_sgd_step`` against the ``sgd_step`` body of
``strom/cli.py``'s ViT bench (rebuilt here from ``strom.models.vit``),
``patchify`` at odd grid sizes, ViT-B/16's parameter shapes; and
``make_vit_wds_pipeline``'s batches over a striped alias, byte for byte
against ``make_wds_vision_pipeline``'s and the JAX package's
``make_vit_wds_pipeline``'s.

Tolerances. f32: both sides compute the same f32 expression and differ only
in the order of f32 sums (matmuls, layer-norm statistics, softmax), a few
ulps: logits at rtol 1e-5 (plus 1e-5 of the largest logit for those near
0), gradients at 1e-4 of each tensor's largest (three chained products per
element), the loss at rtol 1e-5. bf16: activations are rounded to bf16
after every matmul, layer norm and GELU; where the two sides' f32 sums
differ by an ulp before a rounding, an element lands one bf16 ulp (2^-8
relative) away, and the difference travels on through the layers and the
residual stream: 3e-2 of the largest logit."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.models import vit as jvit
from strom.models.resnet import normalize_images as j_normalize
from strom.parallel.mesh import make_mesh
from strom.pipelines.vision import make_vit_wds_pipeline as j_make_vit
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.engine.raid0 import stripe_file
from strom_torch.models import vit as tvit
from strom_torch.parallel.train import make_vit_sgd_step
from strom_torch.pipelines import make_vit_wds_pipeline, make_wds_vision_pipeline
from tests.test_formats import make_wds_shard


def _cfgs(dtype: str):
    return (dataclasses.replace(jvit.ViTConfig.tiny(), dtype=dtype),
            dataclasses.replace(tvit.ViTConfig.tiny(), dtype=dtype))


def _model(jcfg, tcfg, seed=0):
    params = jvit.init_params(jax.random.key(seed), jcfg)
    model = tvit.ViT(tcfg, device="cpu")
    model.load_state_dict(tvit.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, model


def _images(seed=0, n=4, size=32) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    params, model = _model(jcfg, tcfg)
    images = _images()
    want = np.asarray(jvit.forward(params, jnp.asarray(images), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (4, tcfg.num_classes)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=3e-2 * scale)


def test_param_shapes_match_reference():
    """ViT-B/16 at full width: every tensor of the JAX package's tree, split
    per layer, with its shape and dtype (traced, nothing allocated)."""
    cfg = tvit.ViTConfig.vit_b16()
    tree = jax.eval_shape(lambda: jvit.init_params(jax.random.key(0),
                                                   jvit.ViTConfig.vit_b16()))
    model = tvit.ViT(cfg, device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in model.state_dict().items()}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        dt = str(leaf.dtype)
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                want[".".join(["layers", str(i), *keys[1:]])] = (
                    tuple(leaf.shape[1:]), dt)
        else:
            want[".".join(keys)] = (tuple(leaf.shape), dt)
    assert got == want
    assert sum(math.prod(s) for s, _ in got.values()) == 86_530_792


@pytest.mark.parametrize("shape,patch", [((2, 40, 24, 3), 8),   # 5 x 3 grid
                                         ((1, 56, 56, 3), 8),   # 7 x 7
                                         ((3, 48, 16, 3), 16)])  # 3 x 1
def test_patchify_odd_grid(shape, patch):
    x = np.random.default_rng(1).integers(0, 256, shape).astype(np.float32)
    want = np.asarray(jvit.patchify(jnp.asarray(x), patch))
    got = tvit.patchify(torch.from_numpy(x), patch)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sgd_step_matches_reference():
    """One step in f32: the loss, every gradient, and the parameters after
    ``w - 1e-3·g``, against the reference's jitted body on the same uint8
    images and labels (taken % num_classes by both)."""
    jcfg, tcfg = _cfgs("float32")
    params, model = _model(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, 4, dtype=np.int32)

    def loss_of(p):
        return jvit.loss_fn(p, j_normalize(jnp.asarray(images)),
                            jnp.asarray(labels) % jcfg.num_classes, jcfg)

    jloss, jgrads = jax.value_and_grad(loss_of)(params)
    jnew = jax.tree.map(lambda w, g: w - 1e-3 * g, params, jgrads)
    want_grads = tvit.params_from_jax(jax.tree.map(np.asarray, jgrads))
    want_new = tvit.params_from_jax(jax.tree.map(np.asarray, jnew))

    step = make_vit_sgd_step(tcfg, device="cpu")
    m = step(model, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(m["loss"].item(), float(jloss), rtol=1e-5)
    assert np.isfinite(m["grad_norm"].item())
    for name, p in model.named_parameters():
        g, w = want_grads[name], want_new[name]
        torch.testing.assert_close(p.grad, g, rtol=0,
                                   atol=1e-4 * g.abs().max().item() + 1e-9,
                                   msg=name)
        # w - 1e-3·g moves w by 1e-3 of a gradient held to 1e-4 of its max
        torch.testing.assert_close(p.detach(), w, rtol=0,
                                   atol=1e-6 * g.abs().max().item() + 1e-7,
                                   msg=name)


def test_sgd_step_keeps_bf16_params_bf16():
    jcfg, tcfg = _cfgs("bfloat16")
    _, model = _model(jcfg, tcfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_vit_sgd_step(tcfg, device="cpu")
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 32, 32, 3), dtype=np.uint8))
    m = step(model, images, torch.tensor([3, 17], dtype=torch.int32))
    assert np.isfinite(m["loss"].item())
    for n, p in model.named_parameters():
        assert p.dtype == before[n].dtype, n
    assert model.layers[0].wqkv.dtype == torch.bfloat16
    assert model.head.w.dtype == torch.float32
    assert not torch.equal(model.layers[0].wqkv, before["layers.0.wqkv"])


# ------------------------------------------------------------ the loader
N, BATCH, SIZE, CHUNK = 24, 8, 32, 8192


@pytest.fixture(scope="module")
def striped_wds(tmp_path_factory):
    """24 seeded noise JPEGs (cv2, quality 90) in one tar, striped RAID0
    over 4 members in 8 KiB chunks."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(9)
    samples = []
    for i in range(N):
        img = rng.integers(0, 256, (64 + 5 * (i % 3), 80, 3), dtype=np.uint8)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        samples.append((f"s{i:04d}", {"jpg": buf.tobytes(),
                                      "cls": str(i % 7).encode()}))
    d = tmp_path_factory.mktemp("vitwds")
    tar = str(d / "shard.tar")
    make_wds_shard(tar, samples)
    members = [str(d / f"m{i}.bin") for i in range(4)]
    assert stripe_file(tar, members, CHUNK) == os.path.getsize(tar)
    return tar, members


def _port(make, members, tar, **kw):
    ctx = StromContext(StromConfig(engine="python", queue_depth=8,
                                   num_buffers=8))
    alias = tar + ".raid0"
    try:
        ctx.register_striped(alias, members, CHUNK, size=os.path.getsize(tar))
        with make(ctx, [alias], batch=BATCH, image_size=SIZE, device="cpu",
                  seed=13, decode_workers=2, **kw) as pipe:
            return [tuple(t.numpy().copy() for t in next(pipe))
                    for _ in range(4)], pipe.stats()
    finally:
        ctx.close()


def test_vit_wds_pipeline_over_striped_alias(striped_wds):
    tar, members = striped_wds
    vit_batches, stats = _port(make_vit_wds_pipeline, members, tar)
    wds_batches, _ = _port(make_wds_vision_pipeline, members, tar)
    assert stats["scope"] == {"pipeline": "vit"}
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jctx = JContext(JConfig(engine="python", queue_depth=8, num_buffers=8))
    alias = tar + ".raid0"
    try:
        jctx.register_striped(alias, members, CHUNK, size=os.path.getsize(tar))
        with j_make_vit(jctx, [alias], batch=BATCH, image_size=SIZE,
                        sharding=NamedSharding(mesh, P("dp", None, None, None)),
                        seed=13, decode_workers=2) as pipe:
            ref = [tuple(np.asarray(a) for a in next(pipe)) for _ in range(4)]
    finally:
        jctx.close()
    for (a, la), (b, lb), (c, lc) in zip(vit_batches, wds_batches, ref):
        assert a.shape == (BATCH, SIZE, SIZE, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(la, lc)
