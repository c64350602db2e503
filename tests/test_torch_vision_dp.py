"""The vision pipelines and the ResNet and ViT steps on a mesh, held to the
JAX package's dp-2 mesh on the conftest's CPU devices: one world-2 run of
real processes (torch.distributed over gloo on localhost, spawned from
this file's ``__main__`` block), each rank checked against the reference's
shard at its mesh position:

- each rank's local image and label blocks of
  ``make_wds_vision_pipeline(sharding=P("dp", None, None, None))``,
  streamed and barrier, and of ``make_predecoded_vision_pipeline``, equal
  the JAX pipelines' shards bit for bit over two epochs (the Philox keys
  are the global row's);
- the predecoded rank's engine read only its rows' bytes;
- two data-parallel steps of ``ResNetConfig.tiny()`` (f32, batch norm over
  the global batch) and of ``ViTConfig.tiny()`` (f32) track the
  reference's jitted SGD step over the ``P("dp")`` batch: losses and grad
  norms within 1e-4, parameters and batch-norm statistics within 1e-5 of
  each tensor's largest value (``test_torch_resnet.py``'s f32 tolerance);
  the replicas end bit-equal.

And in one process: a spec that splits H, W or C raises, and so does
``device=`` beside ``sharding=``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD, B, SIZE, N, BATCHES, STEPS, LR = 2, 8, 32, 24, 6, 2, 1e-3
ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
ARMS = ("streamed", "barrier", "predecoded")


# ---------------------------------------------------- the rank's program
def _worker(r: int, port: int, d: str) -> None:
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.models import resnet as tres
    from strom_torch.models import vit as tvit
    from strom_torch.parallel import mesh as tmesh
    from strom_torch.parallel import train as ttrain
    from strom_torch.parallel.sharding import P, TorchSharding, local_tensor
    from strom_torch.pipelines import (make_predecoded_vision_pipeline,
                                       make_wds_vision_pipeline)

    torch.set_num_threads(2)
    tmesh.init_distributed("cpu", rank=r, world_size=WORLD,
                           init_method=f"tcp://localhost:{port}")
    mesh = tmesh.make_mesh({"dp": WORLD})
    sharding = TorchSharding(mesh, P("dp", None, None, None))
    ctx = StromContext(StromConfig(engine="python"))
    tar, pdec = os.path.join(d, "shard.tar"), os.path.join(d, "shard.pdec")
    got: dict = {}
    out: dict = {}
    for arm in ARMS:
        eng0 = ctx.engine.stats()["bytes_read"]
        xfer0 = ctx.stats()["context"]["transfers"]
        if arm == "predecoded":
            pipe = make_predecoded_vision_pipeline(
                ctx, [pdec], batch=B, image_size=SIZE, sharding=sharding,
                seed=7)
        else:
            pipe = make_wds_vision_pipeline(
                ctx, [tar], batch=B, image_size=SIZE, sharding=sharding,
                seed=7, decode_workers=2,
                stream_intra_batch=arm == "streamed")
        with pipe:
            got[arm] = [next(pipe) for _ in range(BATCHES)]
        out[arm] = {"shapes": [[list(t.shape) for t in b] for b in got[arm]],
                    "bytes_read": ctx.engine.stats()["bytes_read"] - eng0,
                    "transfers": ctx.stats()["context"]["transfers"] - xfer0}
    ctx.close()
    finals = {}
    for name, mod, batches in (("resnet", tres, got["predecoded"]),
                               ("vit", tvit, got["streamed"])):
        cfg = dataclasses.replace(mod.ResNetConfig.tiny() if name == "resnet"
                                  else mod.ViTConfig.tiny(), dtype="float32")
        init = dict(np.load(os.path.join(d, f"{name}_init.npz")))
        model = (mod.ResNet if name == "resnet" else mod.ViT)(cfg,
                                                              device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in init.items()})
        make = ttrain.make_resnet_sgd_step if name == "resnet" \
            else ttrain.make_vit_sgd_step
        step = make(cfg, lr=LR, device="cpu", mesh=mesh)
        curve = []
        for imgs, lbls in batches[:STEPS]:
            m = step(model, imgs, lbls)
            curve.append([float(m["loss"]), float(m["grad_norm"])])
        out[f"{name}_curve"] = curve
        finals[name] = {k: v.detach().numpy()
                        for k, v in model.state_dict().items()}
    np.savez(os.path.join(d, f"rank{r}.npz"),
             **{f"{arm}_{i}_{j}": local_tensor(t).numpy()
                for arm in ARMS for i, b in enumerate(got[arm])
                for j, t in enumerate(b)},
             **{f"{name}.{k}": v for name, sd in finals.items()
                for k, v in sd.items()})
    with open(os.path.join(d, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    tmesh.shutdown()


# --------------------------------------------------------------- the tests
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fixtures(d: str) -> None:
    """24 seeded noise JPEGs of varying sizes with ASCII labels, and the
    reference's predecoded shard of them at 32²."""
    import cv2

    from strom.config import StromConfig as JConfig
    from strom.delivery.core import StromContext as JContext
    from strom.formats.predecoded import predecode_wds
    from tests.test_formats import make_wds_shard

    rng = np.random.default_rng(21)
    samples = []
    for i in range(N):
        img = rng.integers(0, 256, (72 + 5 * (i % 4), 80 + 3 * (i % 5), 3),
                           dtype=np.uint8)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        samples.append((f"s{i:04d}", {"jpg": buf.tobytes(),
                                      "cls": str(i % 10).encode()}))
    make_wds_shard(os.path.join(d, "shard.tar"), samples)
    ctx = JContext(JConfig(engine="python"))
    try:
        predecode_wds(ctx, [os.path.join(d, "shard.tar")],
                      os.path.join(d, "shard.pdec"), image_size=SIZE,
                      decode_workers=2)
    finally:
        ctx.close()


def _jax_reference(d: str):
    """The JAX pipelines' shards at each dp-2 position, and the reference's
    jitted SGD steps of the tiny ResNet and ViT over the same global
    batches from the parameters the ranks load."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from strom.config import StromConfig as JConfig
    from strom.delivery.core import StromContext as JContext
    from strom.models import resnet as jres
    from strom.models import vit as jvit
    from strom.parallel.mesh import make_mesh
    from strom.pipelines.vision import (make_predecoded_vision_pipeline,
                                        make_wds_vision_pipeline)
    from strom_torch.models import resnet as tres
    from strom_torch.models import vit as tvit

    devs = jax.devices()[:WORLD]
    mesh = make_mesh({"dp": WORLD}, devices=devs)
    sharding = NamedSharding(mesh, JP("dp", None, None, None))
    batches = {}
    ctx = JContext(JConfig(engine="python"))
    try:
        with make_wds_vision_pipeline(
                ctx, [os.path.join(d, "shard.tar")], batch=B, image_size=SIZE,
                sharding=sharding, seed=7, decode_workers=2) as pipe:
            batches["wds"] = [next(pipe) for _ in range(BATCHES)]
        with make_predecoded_vision_pipeline(
                ctx, [os.path.join(d, "shard.pdec")], batch=B,
                image_size=SIZE, sharding=sharding, seed=7) as pipe:
            batches["predecoded"] = [next(pipe) for _ in range(BATCHES)]
    finally:
        ctx.close()

    def shard(a, dev):
        return np.asarray(next(s.data for s in a.addressable_shards
                               if s.device == dev))

    shards = {arm: [[[shard(t, dev) for t in b] for b in batches[arm]]
                    for dev in devs] for arm in batches}

    def global_norm(grads):
        return jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                            for g in jax.tree.leaves(grads)))

    curves, finals = {}, {}
    rcfg = dataclasses.replace(jres.ResNetConfig.tiny(), dtype="float32")
    params, state = jres.init_params(jax.random.key(4), rcfg)
    np.savez(os.path.join(d, "resnet_init.npz"),
             **{k: v.numpy() for k, v in
                tres.params_from_jax(params, state).items()})

    @jax.jit
    def resnet_step(p, s, images, labels):
        (loss, new_s), grads = jax.value_and_grad(
            jres.loss_fn, has_aux=True)(p, s, jres.normalize_images(images),
                                        labels % rcfg.num_classes, rcfg)
        new_p = jax.tree.map(lambda w, g: w - LR * g, p, grads)
        return new_p, new_s, loss, global_norm(grads)

    curves["resnet"] = []
    for imgs, lbls in batches["predecoded"][:STEPS]:
        params, state, loss, norm = resnet_step(params, state, imgs, lbls)
        curves["resnet"].append([float(loss), float(norm)])
    finals["resnet"] = {k: v.numpy() for k, v in tres.params_from_jax(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, state)).items()}

    vcfg = dataclasses.replace(jvit.ViTConfig.tiny(), dtype="float32")
    vparams = jvit.init_params(jax.random.key(5), vcfg)
    np.savez(os.path.join(d, "vit_init.npz"),
             **{k: v.numpy() for k, v in tvit.params_from_jax(
                 jax.tree.map(np.asarray, vparams)).items()})

    @jax.jit
    def vit_step(p, images, labels):
        loss, grads = jax.value_and_grad(jvit.loss_fn)(
            p, jres.normalize_images(images), labels % vcfg.num_classes,
            vcfg)
        new_p = jax.tree.map(lambda w, g: w - LR * g, p, grads)
        return new_p, loss, global_norm(grads)

    curves["vit"] = []
    for imgs, lbls in batches["wds"][:STEPS]:
        vparams, loss, norm = vit_step(vparams, imgs, lbls)
        curves["vit"].append([float(loss), float(norm)])
    finals["vit"] = {k: v.numpy() for k, v in tvit.params_from_jax(
        jax.tree.map(np.asarray, vparams)).items()}
    return shards, curves, finals


def test_world_two_vision_matches_jax_dp2(tmp_path):
    d = str(tmp_path)
    _fixtures(d)
    shards, jcurves, jfinals = _jax_reference(d)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port), d],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-4000:]}"
    rows = B // WORLD
    finals = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out = json.load(f)
        arrs = dict(np.load(os.path.join(d, f"rank{r}.npz")))
        for arm in ARMS:
            want = shards["predecoded" if arm == "predecoded" else "wds"][r]
            assert out[arm]["shapes"] == [[[B, SIZE, SIZE, 3], [B]]] * BATCHES
            for i in range(BATCHES):
                for j, what in enumerate(("images", "labels")):
                    np.testing.assert_array_equal(
                        arrs[f"{arm}_{i}_{j}"], want[i][j],
                        err_msg=f"rank {r} {arm} batch {i} {what}")
        # the predecoded rank read its rows' bytes and nothing else
        pre = out["predecoded"]
        assert pre["transfers"] >= BATCHES
        assert pre["bytes_read"] == pre["transfers"] * rows * SIZE * SIZE * 3
        for name in ("resnet", "vit"):
            for i, ((jl, jn), (tl, tn)) in enumerate(
                    zip(jcurves[name], out[f"{name}_curve"])):
                assert abs(tl - jl) < 1e-4, (r, name, i, tl, jl)
                assert abs(tn - jn) <= 1e-4 * max(1.0, jn), (r, name, i, tn,
                                                             jn)
            for k, v in jfinals[name].items():
                scale = max(float(np.abs(v).max()), 1e-6)
                np.testing.assert_allclose(arrs[f"{name}.{k}"], v, rtol=0,
                                           atol=1e-5 * scale,
                                           err_msg=f"{name}.{k}")
        finals.append({k: v for k, v in arrs.items()
                       if k.startswith(("resnet.", "vit."))})
    for k in finals[0]:   # the replicas are bit-equal
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)


@pytest.mark.parametrize("spec", [(None, "dp"), ("dp", None, "dp2"),
                                  ("dp", None, None, "dp2")])
def test_sharding_of_an_inner_dim_raises(tmp_path, spec):
    """The vision pipelines deliver batch-dim-sharded images only."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.sharding import P, TorchSharding
    from strom_torch.pipelines import (make_predecoded_vision_pipeline,
                                       make_wds_vision_pipeline)

    sharding = TorchSharding(make_mesh({"dp": 1, "dp2": 1}), P(*spec))
    with StromContext(StromConfig(engine="python")) as ctx:
        for make in (make_wds_vision_pipeline,
                     make_predecoded_vision_pipeline):
            with pytest.raises(ValueError, match="inner dim"):
                make(ctx, [str(tmp_path / "x")], batch=B, image_size=SIZE,
                     sharding=sharding)


def test_device_and_sharding_together_raise(tmp_path):
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.sharding import P, TorchSharding
    from strom_torch.pipelines import (make_imagenet_resnet_pipeline,
                                       make_predecoded_vision_pipeline,
                                       make_vit_wds_pipeline,
                                       make_wds_vision_pipeline)

    sharding = TorchSharding(make_mesh({"dp": 1}), P("dp", None, None, None))
    with StromContext(StromConfig(engine="python")) as ctx:
        for make in (make_wds_vision_pipeline,
                     make_predecoded_vision_pipeline,
                     make_imagenet_resnet_pipeline, make_vit_wds_pipeline):
            with pytest.raises(ValueError, match="not both"):
                make(ctx, [str(tmp_path / "x")], batch=B, image_size=SIZE,
                     device="cpu", sharding=sharding)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
