"""Sequence parallelism in the port: ``make_train_step(mesh=, sp=True)``
against the JAX package's ``make_train_step(sp=True)`` on the same meshes
(the conftest's CPU devices), one gloo process a rank (this file's
``__main__`` block):

- ``{"dp": 2, "sp": 2}`` with the dense ring, fed by
  ``make_llama_pipeline(sharding=P("dp", "sp"))``; ``{"sp": 4}`` with
  the dense, flash and zigzag rings; the composed ``{"tp": 2, "sp": 2}``
  with the flash ring. 2 steps of ``LlamaConfig.tiny()`` in f32 from the
  JAX package's initial parameters (the first at lr 0, the second moving
  the parameters): losses within 1e-4 and grad norms within 1e-4 relative
  (the dp-2 test's tolerances), the gathered final parameters at rtol
  1e-3, atol 1e-5 (the embedding's 1e-4: ``gloo_ranks.PARAM_ATOL``); the
  ranks that share a tp coordinate end with bit-equal blocks;
- the pipeline case: each rank's block is its rows' slice of the global
  batch, which is the file's records in the reference sampler's order,
  and the engine read only that block (bytes = deliveries × rows × L/sp ×
  4);
- positions and targets across shard boundaries: each sp rank's logits
  equal the whole rows' logits at its columns (RoPE at global positions),
  and the shards' losses sum to the JAX package's loss of the whole rows
  (the last column's target from the next shard).

The JAX side's meshes carry a ``dp`` axis of 1 where the port's have none:
its batch sharding names ``dp``.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import gloo_ranks

WORLD, B, L, STEPS = 4, 2, 64, 2
REC = 16                       # records of the pipeline case's token file
# id: (port mesh axes, JAX mesh axes, attn)
CASES = {
    "dp2sp2_dense": ({"dp": 2, "sp": 2}, {"dp": 2, "sp": 2}, "dense"),
    "sp4_dense": ({"sp": 4}, {"dp": 1, "sp": 4}, "dense"),
    "sp4_flash": ({"sp": 4}, {"dp": 1, "sp": 4}, "flash"),
    "sp4_zigzag": ({"sp": 4}, {"dp": 1, "sp": 4}, "zigzag"),
    "tp2sp2_flash": ({"tp": 2, "sp": 2}, {"dp": 1, "tp": 2, "sp": 2},
                     "flash"),
}
PIPE_CASE = "dp2sp2_dense"


def _batches():
    rng = np.random.default_rng(23)
    return rng.integers(0, 512, (STEPS, B, L), dtype=np.int32)


def _records():
    rng = np.random.default_rng(29)
    return rng.integers(0, 512, (REC, L), dtype=np.int32)


def _pipe_batches():
    """The global batches the pipeline case delivers: the file's records
    in the JAX package's sampler order."""
    from strom.pipelines.sampler import EpochShuffleSampler

    it = iter(EpochShuffleSampler(REC, B, seed=0))
    return np.stack([_records()[next(it)] for _ in range(STEPS)])


# ---------------------------------------------------- the rank's program
def _boundaries(mesh, d: str, r: int) -> None:
    """Logits and loss of a sequence shard against the whole rows'."""
    import torch

    from strom_torch.models import llama
    from strom_torch.models.llama import Llama, next_token_loss
    from strom_torch.parallel.ring import make_ring_attention
    from strom_torch.parallel.sharding import P, TorchSharding

    init = np.load(os.path.join(d, "sp4_dense_init.npz"))
    model = Llama(gloo_ranks.tiny_f32(llama), device="cpu")
    model.load_state_dict({k: torch.from_numpy(init[k]) for k in init.files})
    tokens = torch.from_numpy(_batches()[0])
    sp = mesh.axis("sp")
    (index,) = TorchSharding(mesh, P(None, "sp")).addressable_devices_indices_map(
        tuple(tokens.shape)).values()
    ring = make_ring_attention(mesh)
    with torch.no_grad():
        local = model(tokens[index], positions=(
            sp.index * (L // sp.size) + torch.arange(L // sp.size)).expand(
                B, -1), attn_fn=ring)
        whole = model(tokens)[index]
        loss = next_token_loss(model, tokens[index], attn_fn=ring, sp=sp)
        total = loss.clone()
        torch.distributed.all_reduce(total, group=sp.group)
    np.savez(os.path.join(d, f"bounds_rank{r}.npz"),
             logits_err=float((local - whole).abs().max()),
             loss=float(loss), total=float(total),
             plain=float(next_token_loss(model, tokens)))


def _pipeline(mesh, d: str, r: int) -> None:
    """The sequence-sharded loader into the dp2sp2 dense step."""
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.parallel.sharding import P, TorchSharding, local_tensor
    from strom_torch.pipelines.llama_pretrain import make_llama_pipeline

    ctx = StromContext(StromConfig(engine="python"))
    eng0 = ctx.engine.stats()["bytes_read"]
    xfer0 = ctx.stats()["context"]["transfers"]
    pipe = make_llama_pipeline(ctx, [os.path.join(d, "tokens.bin")], batch=B,
                               seq_len=L - 1,
                               sharding=TorchSharding(mesh, P("dp", "sp")),
                               prefetch_depth=2)
    got = [next(pipe) for _ in range(STEPS)]
    pipe.close()
    nbytes = ctx.engine.stats()["bytes_read"] - eng0
    xfers = ctx.stats()["context"]["transfers"] - xfer0
    ctx.close()
    np.savez(os.path.join(d, f"pipe_rank{r}.npz"),
             local=np.stack([local_tensor(g).numpy() for g in got]),
             full=np.stack([g.full_tensor().numpy() for g in got]))
    with open(os.path.join(d, f"pipe_rank{r}.json"), "w") as f:
        json.dump({"bytes": nbytes, "transfers": xfers,
                   "shape": [list(g.shape) for g in got]}, f)
    gloo_ranks.train_case(mesh, d, PIPE_CASE, got, attn="dense", sp=True,
                          rank=r)


def _worker(argv) -> None:
    from strom_torch.parallel import mesh as pmesh

    r, world, d = gloo_ranks.join(argv)
    meshes = {}
    for cid, (axes, _, attn) in CASES.items():
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = pmesh.make_mesh(axes)
        if cid == PIPE_CASE:
            _pipeline(meshes[key], d, r)
        else:
            gloo_ranks.train_case(meshes[key], d, cid, _batches(),
                                  attn=attn, sp=True, rank=r)
    _boundaries(meshes[(("sp", 4),)], d, r)
    pmesh.shutdown()


# --------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks, started once the JAX states exist (their parameters are
    the ranks' start); the JAX steps run while the ranks run."""
    import jax.numpy as jnp

    from strom.models import llama as jllama
    from strom_torch.models.llama import LAYER_PARAMS

    d = str(tmp_path_factory.mktemp("sp_step"))
    runners = {cid: gloo_ranks.jax_case(d, cid, jaxes, attn=attn, sp=True)
               for cid, (_, jaxes, attn) in CASES.items()}
    _records().tofile(os.path.join(d, "tokens.bin"))
    procs = gloo_ranks.start(__file__, WORLD, d)
    # XLA compiles dominate: two at a time
    with ThreadPoolExecutor(2) as ex:
        futures = {cid: ex.submit(run, _pipe_batches() if cid == PIPE_CASE
                                  else _batches())
                   for cid, run in runners.items()}
        jax_out = {cid: f.result() for cid, f in futures.items()}
    init = np.load(os.path.join(d, "sp4_dense_init.npz"))
    params = {"embed": jnp.asarray(init["embed"]),
              "layers": {k: jnp.asarray(init[k]) for k in LAYER_PARAMS},
              "final_norm": jnp.asarray(init["final_norm"]),
              "lm_head": jnp.asarray(init["lm_head"])}
    plain = float(jllama.next_token_loss(params, jnp.asarray(_batches()[0]),
                                         gloo_ranks.tiny_f32(jllama)))
    gloo_ranks.wait(procs)
    return d, jax_out, plain


def _rank(d, cid, r):
    return np.load(os.path.join(d, f"{cid}_rank{r}.npz"))


@pytest.mark.parametrize("cid", list(CASES))
def test_curve_matches_jax(runs, cid):
    d, jax_out, *_ = runs
    for r in range(WORLD):
        gloo_ranks.check_curve(_rank(d, cid, r)["curve"], jax_out[cid][0])


@pytest.mark.parametrize("cid", list(CASES))
def test_final_params_match_jax(runs, cid):
    d, jax_out, *_ = runs
    got = _rank(d, cid, 0)
    gloo_ranks.check_params({k: got[f"full_{k}"] for k in jax_out[cid][1]},
                            jax_out[cid][1])


@pytest.mark.parametrize("cid", list(CASES))
def test_replicas_bit_equal(runs, cid):
    """Ranks that share a tp coordinate hold bit-equal blocks; the gathered
    parameters are the same on every rank (so are the tp-replicated
    ones)."""
    from strom_torch.parallel.mesh import make_mesh

    d, *_ = runs
    axes = CASES[cid][0]
    mesh = make_mesh(axes, devices=range(WORLD))
    ranks = [_rank(d, cid, r) for r in range(WORLD)]

    def tp_of(r):
        return mesh.coords(r)[mesh.axis_names.index("tp")] \
            if "tp" in axes else 0

    for r in range(1, WORLD):
        twin = min(s for s in range(WORLD) if tp_of(s) == tp_of(r))
        for k in ranks[r].files:
            if k != "curve":
                want = ranks[0 if k.startswith("full_") else twin][k]
                np.testing.assert_array_equal(ranks[r][k], want, err_msg=k)


def test_positions_and_targets_across_shards(runs):
    """Each shard's logits at global positions equal the whole rows'; the
    shards' losses sum to the whole rows' loss, the port's and the JAX
    package's."""
    d, _, plain = runs
    got = [np.load(os.path.join(d, f"bounds_rank{r}.npz"))
           for r in range(WORLD)]
    for g in got:
        assert float(g["logits_err"]) < 1e-5
        assert abs(float(g["total"]) - float(g["plain"])) < 1e-5
        assert abs(float(g["plain"]) - plain) < 1e-5
    assert abs(sum(float(g["loss"]) for g in got) - plain) < 1e-5


def test_pipeline_feeds_sp_step(runs):
    """Each rank's block of the P("dp", "sp") batch is its slice of the
    global batch, which is the file's records in the reference sampler's
    order, and the engine read exactly that block. (The step on these
    batches: the dp2sp2_dense cases above.)"""
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.sharding import P, TorchSharding

    d, *_ = runs
    mesh = make_mesh({"dp": 2, "sp": 2}, devices=range(WORLD))
    index = TorchSharding(mesh, P("dp", "sp")).devices_indices_map((B, L))
    want = _pipe_batches()
    for r in range(WORLD):
        arrs = np.load(os.path.join(d, f"pipe_rank{r}.npz"))
        with open(os.path.join(d, f"pipe_rank{r}.json")) as f:
            out = json.load(f)
        np.testing.assert_array_equal(arrs["full"], want)
        for local, full in zip(arrs["local"], want):
            np.testing.assert_array_equal(local, full[index[r]])
        assert out["shape"] == [[B, L]] * STEPS
        assert out["transfers"] >= STEPS
        assert out["bytes"] == out["transfers"] * (B // 2) * (L // 2) * 4


if __name__ == "__main__":
    _worker(sys.argv)
