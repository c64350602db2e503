"""Tensor parallelism in the port against the JAX package, one gloo process
a rank on a ``{"dp": 2, "tp": 2}`` mesh (this file's ``__main__`` block),
``LlamaConfig.tiny()`` in f32 (so tp is 2: its 2 kv heads):

- ``shard_params`` gives each rank the block that the JAX package's
  ``param_shardings`` gives the device at its mesh position, for every
  rule, and ``gather_params`` puts the blocks back together exactly;
- ``block_tp`` on the local blocks against ``strom.models.llama.block`` on
  the full layer: output, and the gradients of ``sum(y · w)`` in x and in
  each local weight block (the Megatron operators' backward); relative
  and absolute 1e-4 in f32 (the row-parallel matmuls sum their halves in
  another order);
- the vocab-parallel loss and its gradient against the plain
  logsumexp − gold logit, at 1e-5;
- 3 steps of ``make_train_step(mesh=)`` against the JAX package's on the
  same mesh at ``test_world_two_matches_jax_dp2``'s tolerances: losses
  within 1e-4, grad norms within 1e-4 relative, gathered final parameters
  at rtol 1e-3, atol 1e-5 (the embedding's 1e-4, for the reason
  ``gloo_ranks.PARAM_ATOL`` gives); the replicas end bit-equal;
- ``replicate`` keeps each rank's own shard: ranks of dp index 1 start
  from zeros and end with the blocks of their tp coordinate;
- ``train_state_tree`` of a tp-sharded state raises, and the step's
  argument checks.
"""

import os
import sys

import numpy as np
import pytest

import gloo_ranks

WORLD, AXES, STEPS = 4, {"dp": 2, "tp": 2}, 3
B, L = 4, 32
TOL_BLOCK, TOL_LOSS = 1e-4, 1e-5


def _batches():
    rng = np.random.default_rng(31)
    return rng.integers(0, 512, (STEPS, B, L), dtype=np.int32)


def _block_inputs():
    rng = np.random.default_rng(37)
    return {"x": rng.normal(size=(2, 16, 128)).astype(np.float32),
            "w": rng.normal(size=(2, 16, 128)).astype(np.float32)}


def _ce_inputs():
    rng = np.random.default_rng(41)
    return {"logits": rng.normal(size=(24, 512)).astype(np.float32) * 3,
            "targets": rng.integers(0, 512, 24),
            "c": rng.normal(size=24).astype(np.float32)}


# ---------------------------------------------------- the rank's program
def _worker(argv) -> None:
    import torch

    from strom_torch.models import llama
    from strom_torch.parallel import mesh as pmesh
    from strom_torch.parallel import train
    from strom_torch.parallel.sharding import gather_params, shard_params
    from strom_torch.parallel.tensor_parallel import (block_tp,
                                                      vocab_parallel_ce)

    r, world, d = gloo_ranks.join(argv)
    mesh = pmesh.make_mesh(AXES)
    tp = mesh.axis("tp")
    cfg = gloo_ranks.tiny_f32(llama)
    init = np.load(os.path.join(d, "dp2tp2_init.npz"))
    full = {k: torch.from_numpy(init[k]) for k in init.files}
    out = {}
    # the round trip
    local = shard_params(full, mesh)
    out.update({f"shard_{k}": v.numpy() for k, v in local.items()})
    out.update({f"gathered_{k}": v.numpy() for k, v in
                gather_params(local, mesh).items()})
    # block_tp on layer 0's blocks
    x = {k: torch.from_numpy(v) for k, v in _block_inputs().items()}
    xin = x["x"].clone().requires_grad_(True)
    lp = {n: local[n][0].clone().requires_grad_(True)
          for n in llama.LAYER_PARAMS}
    positions = torch.arange(16).expand(2, 16)
    y = block_tp(xin, lp, cfg, positions, tp=tp)
    (y * x["w"]).sum().backward()
    out["block_y"] = y.detach().numpy()
    out["block_dx"] = xin.grad.numpy()
    out.update({f"block_d{n}": p.grad.numpy() for n, p in lp.items()})
    # the vocab-parallel loss on this rank's columns
    ce = _ce_inputs()
    width = 512 // tp.size
    logits = torch.from_numpy(
        ce["logits"][:, tp.index * width:(tp.index + 1) * width].copy()
    ).requires_grad_(True)
    per = vocab_parallel_ce(logits, torch.from_numpy(ce["targets"]), tp)
    (per * torch.from_numpy(ce["c"])).sum().backward()
    out["ce_per"] = per.detach().numpy()
    out["ce_grad"] = logits.grad.numpy()
    # replicate: dp index 1 starts from zeros
    params = full if mesh.axis_index("dp") == 0 else \
        {k: torch.zeros_like(v) for k, v in full.items()}
    state = train.init_train_state(cfg, device="cpu", params=params,
                                   mesh=mesh)
    out.update({f"replicated_{k}": v.detach().numpy()
                for k, v in state.model.named_parameters()})
    try:
        train.train_state_tree(state)
        out["tree_raised"] = False
    except NotImplementedError:
        out["tree_raised"] = True
    np.savez(os.path.join(d, f"parts_rank{r}.npz"), **out)
    gloo_ranks.train_case(mesh, d, "dp2tp2", _batches(), attn="dense",
                          sp=False, rank=r)
    pmesh.shutdown()


# --------------------------------------------------------------- the tests
def _jax_mesh():
    import jax

    from strom.parallel.mesh import make_mesh

    return make_mesh(AXES, devices=jax.devices()[:WORLD])


def _jax_index(name, shape):
    """{rank: the block of parameter *name* the JAX package's
    param_shardings gives mesh device *rank*}."""
    import jax

    from strom.parallel.sharding import param_shardings
    from strom_torch.models.llama import LAYER_PARAMS

    leaf = ("layers", name) if name in LAYER_PARAMS else (name,)
    tree = {"embed": 0, "layers": {k: 0 for k in LAYER_PARAMS},
            "final_norm": 0, "lm_head": 0}
    sh = param_shardings(tree, _jax_mesh())
    sh = sh["layers"][name] if leaf[0] == "layers" else sh[name]
    return {d.id: i for d, i in sh.devices_indices_map(shape).items()
            if d in jax.devices()[:WORLD]}


def _jax_block_and_ce(init):
    """The JAX package's block (layer 0, full weights) with the gradients
    of sum(y · w) in x and the weights; the plain loss and its gradient."""
    import jax
    import jax.numpy as jnp

    from strom.models import llama as jllama
    from strom_torch.models.llama import LAYER_PARAMS

    cfg = gloo_ranks.tiny_f32(jllama)
    b = _block_inputs()
    lp = {n: jnp.asarray(init[n][0]) for n in LAYER_PARAMS}
    positions = jnp.broadcast_to(jnp.arange(16), (2, 16))

    def f(x, lp):
        return jnp.sum(jllama.block(x, lp, cfg, positions) * b["w"])

    y = jllama.block(jnp.asarray(b["x"]), lp, cfg, positions)
    dx, dlp = jax.grad(f, argnums=(0, 1))(jnp.asarray(b["x"]), lp)
    out = {"block_y": np.asarray(y), "block_dx": np.asarray(dx)}
    out.update({f"block_d{n}": np.asarray(v) for n, v in dlp.items()})
    ce = _ce_inputs()

    def loss(logits):
        per = jax.nn.logsumexp(logits, axis=-1) - jnp.take_along_axis(
            logits, jnp.asarray(ce["targets"])[:, None], axis=-1)[:, 0]
        return per

    out["ce_per"] = np.asarray(loss(jnp.asarray(ce["logits"])))
    out["ce_grad"] = np.asarray(jax.grad(
        lambda lg: jnp.sum(loss(lg) * ce["c"]))(jnp.asarray(ce["logits"])))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    run = gloo_ranks.jax_case(d, "dp2tp2", AXES, attn="dense", sp=False)
    procs = gloo_ranks.start(__file__, WORLD, d)
    init = dict(np.load(os.path.join(d, "dp2tp2_init.npz")))
    jax_parts = _jax_block_and_ce(init)
    curve, final = run(_batches())
    gloo_ranks.wait(procs)
    parts = [np.load(os.path.join(d, f"parts_rank{r}.npz"))
             for r in range(WORLD)]
    return d, init, parts, jax_parts, curve, final


PARAMS = ["embed", "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
          "w_up", "w_down", "final_norm", "lm_head"]


@pytest.mark.parametrize("name", PARAMS)
def test_shard_and_gather_round_trip(runs, name):
    _, init, parts, *_ = runs
    index = _jax_index(name, init[name].shape)
    for r in range(WORLD):
        np.testing.assert_array_equal(parts[r][f"shard_{name}"],
                                      init[name][index[r]])
        np.testing.assert_array_equal(parts[r][f"gathered_{name}"],
                                      init[name])


def _tp_block(name, full_shape):
    """Rank 0..3's slice of layer-0 weight *name* (its tp block)."""
    return _jax_index(name, (1, *full_shape))


@pytest.mark.parametrize("key", ["block_y", "block_dx"] + [
    f"block_d{n}" for n in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                            "w_gate", "w_up", "w_down")])
def test_block_tp_matches_block(runs, key):
    _, _, parts, jax_parts, *_ = runs
    want = jax_parts[key]
    for r in range(WORLD):
        got = parts[r][key]
        if key.startswith("block_d") and key != "block_dx":
            index = _tp_block(key[len("block_d"):], want.shape)[r]
            want_r = want[None][index][0]
        else:
            want_r = want
        np.testing.assert_allclose(got, want_r, rtol=TOL_BLOCK,
                                   atol=TOL_BLOCK, err_msg=f"rank {r}")


@pytest.mark.parametrize("key", ["ce_per", "ce_grad"])
def test_vocab_parallel_loss(runs, key):
    _, _, parts, jax_parts, *_ = runs
    want = jax_parts[key]
    for r in range(WORLD):
        tp = r % 2            # rank r's tp index on the row-major mesh
        w = want if key == "ce_per" else want[:, tp * 256:(tp + 1) * 256]
        np.testing.assert_allclose(parts[r][key], w, rtol=TOL_LOSS,
                                   atol=TOL_LOSS, err_msg=f"rank {r}")


def test_step_curve_matches_jax(runs):
    d, *_, curve, _ = runs
    for r in range(WORLD):
        got = np.load(os.path.join(d, f"dp2tp2_rank{r}.npz"))["curve"]
        gloo_ranks.check_curve(got, curve)


@pytest.mark.parametrize("name", PARAMS)
def test_step_final_params_match_jax(runs, name):
    d, *_, final = runs
    for r in range(WORLD):
        got = np.load(os.path.join(d, f"dp2tp2_rank{r}.npz"))
        gloo_ranks.check_params({name: got[f"full_{name}"]},
                                {name: final[name]}, f"rank {r}")
        # dp replicas (ranks r and r ^ 2 share a tp index) bit-equal
        np.testing.assert_array_equal(
            got[name], np.load(os.path.join(
                d, f"dp2tp2_rank{r ^ 2}.npz"))[name])


def test_replicate_keeps_each_ranks_shard(runs):
    _, init, parts, *_ = runs
    for name in PARAMS:
        index = _jax_index(name, init[name].shape)
        for r in range(WORLD):
            np.testing.assert_array_equal(parts[r][f"replicated_{name}"],
                                          init[name][index[r]],
                                          err_msg=f"{name} rank {r}")


def test_train_state_tree_refuses_a_tp_state(runs):
    _, _, parts, *_ = runs
    assert all(bool(p["tree_raised"]) for p in parts)


def test_tp_divisibility_and_step_arguments():
    from strom_torch.models.llama import LlamaConfig
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.tensor_parallel import check_tp
    from strom_torch.parallel.train import make_train_step

    cfg = LlamaConfig.tiny()
    check_tp(cfg, 2)
    with pytest.raises(ValueError, match="must divide by tp 3"):
        check_tp(cfg, 3)
    with pytest.raises(ValueError, match="must divide by tp 4"):
        check_tp(cfg, 4)          # 2 kv heads
    with pytest.raises(ValueError, match="attn must be"):
        make_train_step(cfg, attn="ring", device="cpu")
    with pytest.raises(ValueError, match="needs sp=True"):
        make_train_step(cfg, attn="zigzag", device="cpu")
    with pytest.raises(ValueError, match="pass mesh="):
        make_train_step(cfg, sp=True, device="cpu")
    with pytest.raises(ValueError, match="'sp' axis"):
        make_train_step(cfg, sp=True, device="cpu",
                        mesh=make_mesh({"dp": 1}))
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        make_train_step(cfg, device="cpu",
                        mesh=make_mesh({"pp": 2}, devices=[0, 1]))


if __name__ == "__main__":
    _worker(sys.argv)
