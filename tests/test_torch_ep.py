"""Expert parallelism in the port: ``make_moe_train_step(mesh=)`` against
the JAX package's ``make_moe_train_step`` on the same meshes (the
conftest's CPU devices), one gloo process a rank (this file's
``__main__`` block), 2 steps of ``MoEConfig.tiny()`` in f32 from the JAX
package's initial parameters (the first at lr 0, the second moving them):

- ``{"dp": 2, "ep": 2}`` dense at capacity factors 1.25 and 0.5,
  ``{"ep": 4}`` dense, ``{"ep": 2, "sp": 2}`` with the flash ring at
  0.5 (the queue then runs across sp shards that overflow), and
  ``{"sp": 2, "dp": 2}`` with the dense ring at 0.5 (a mesh whose ranks
  are not in (dp, sp) order);
- losses within 1e-4 and grad norms within 1e-4 relative, the gathered
  final parameters at rtol 1e-3, atol 1e-5 (the embedding's 1e-4:
  ``gloo_ranks.PARAM_ATOL``; ``QUIET_G`` says which few embedding
  elements are held to Adam's largest step instead, and why); every
  rank's gathered parameters bit-equal,
  and each rank's blocks bit-equal to those of the first rank of its ep
  coordinate;
- the global capacity queue: each rank's forward at the initial
  parameters, on its block of the first batch, routes and keeps in every
  layer exactly the tokens that the JAX package's ``switch_route`` routes
  and keeps at those places of the global batch;
- ``replicate`` broadcasts each ep coordinate's own experts;
  ``train_state_tree`` of an ep-sharded state raises; the MoE step raises
  for a tp or pp axis above 1, and the Llama step for ep.

The JAX side's meshes carry a ``dp`` axis of 1 where the port's have none:
its batch sharding names ``dp``.
"""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import gloo_ranks

WORLD, B, L, STEPS = 4, 4, 64, 2
# id: (port mesh axes, JAX mesh axes, attn, sp, capacity factor)
CASES = {
    "dp2ep2_cf125": ({"dp": 2, "ep": 2}, {"dp": 2, "ep": 2}, "dense", False,
                     1.25),
    "dp2ep2_cf05": ({"dp": 2, "ep": 2}, {"dp": 2, "ep": 2}, "dense", False,
                    0.5),
    "ep4": ({"ep": 4}, {"dp": 1, "ep": 4}, "dense", False, 1.25),
    "ep2sp2_flash": ({"ep": 2, "sp": 2}, {"dp": 1, "ep": 2, "sp": 2},
                     "flash", True, 0.5),
    # sp before dp: rank 1 is (dp 0, sp 1) on dp2sp2's mesh and (dp 1,
    # sp 0) here, so the queue's blocks must be placed by coordinates
    "sp2dp2_cf05": ({"sp": 2, "dp": 2}, {"sp": 2, "dp": 2}, "dense", True,
                    0.5),
}


# Embedding elements whose gradient is 0 < |g| < QUIET_G in every step of
# the JAX package's run on the global batch: ten times Adam's eps, where
# Adam's step hangs on g / eps, and about the disagreement of two f32
# computations of one element of that gradient on these batches (the JAX
# package's mesh and one-device gradients up to 4.3e-8 apart, the port's
# one-process gradient up to 9.9e-8 from them: tests/ep_quiet_grads.py).
# Such a gradient's sign is noise: one element of the dp2ep2 and ep4
# batches has -1.4e-8 on the mesh, -9.4e-9 on one device and +4.6e-9 in
# the port, and AdamW takes the JAX pair 3.1e-4 apart there, the port
# 2.5e-3 from the mesh. 1 to 6 elements of 65,536 are quiet in these
# cases. They are held to twice the steps' summed lr (Adam moves an
# element by at most about lr a step), at most QUIET_MAX of them; every
# other element, those of gradients from QUIET_G up included, at
# PARAM_ATOL.
QUIET_G, QUIET_MAX = 1e-7, 8


def _cfg(moe, capacity_factor: float):
    """``MoEConfig.tiny()`` in f32 of either package's moe module."""
    base = dataclasses.replace(moe.MoEConfig.tiny().base, dtype="float32")
    return dataclasses.replace(moe.MoEConfig.tiny(), base=base,
                               capacity_factor=capacity_factor)


def _batches():
    rng = np.random.default_rng(43)
    return rng.integers(0, 512, (STEPS, B, L), dtype=np.int32)


# ---------------------------------------------------- the rank's program
def _case(mesh, d: str, cid: str, r: int) -> None:
    import torch

    from strom_torch.models import moe
    from strom_torch.models.llama import shard_positions
    from strom_torch.parallel import train
    from strom_torch.parallel.expert_parallel import token_layout
    from strom_torch.parallel.ring import make_ring_attention
    from strom_torch.parallel.sharding import (batch_sharding, gather_params,
                                               moe_param_shardings)

    _, _, attn, sp, cf = CASES[cid]
    cfg = _cfg(moe, cf)
    opt = train.make_optimizer(lr=gloo_ranks.LR, warmup=gloo_ranks.WARMUP)
    init = np.load(os.path.join(d, f"{cid}_init.npz"))
    state = train.init_moe_train_state(
        cfg, opt, device="cpu", mesh=mesh,
        params={k: torch.from_numpy(init[k]) for k in init.files})
    sh = batch_sharding(mesh, sp=sp)
    (index,) = sh.addressable_devices_indices_map((B, L)).values()
    blocks = [torch.from_numpy(b[index].copy()) for b in _batches()]
    # the routes of the first batch at the initial parameters
    sp_axis = mesh.axis("sp") if sp else None
    routes = []
    with torch.no_grad():
        state.model(blocks[0], positions=shard_positions(blocks[0], sp_axis),
                    attn_fn=make_ring_attention(mesh, impl=attn) if sp
                    else None, layout=token_layout(mesh, sp), routes=routes)
    step = train.make_moe_train_step(cfg, opt, attn=attn, device="cpu",
                                     mesh=mesh, sp=sp)
    curve = []
    for b in blocks:
        state, m = step(state, b)
        curve.append([float(m["loss"]), float(m["grad_norm"])])
    local = {k: v.detach() for k, v in state.model.named_parameters()}
    full = gather_params(local, mesh, shardings=moe_param_shardings)
    out = {"curve": np.array(curve),
           **{k: v.numpy() for k, v in local.items()},
           **{f"full_{k}": v.numpy() for k, v in full.items()},
           **{f"expert{i}": e.numpy() for i, (e, _) in enumerate(routes)},
           **{f"keep{i}": k.numpy() for i, (_, k) in enumerate(routes)}}
    if cid == "ep4":
        try:
            train.train_state_tree(state)
            out["tree_raised"] = np.array(0)
        except NotImplementedError:
            out["tree_raised"] = np.array(1)
    np.savez(os.path.join(d, f"{cid}_rank{r}.npz"), **out)


def _replicate(mesh, d: str, r: int) -> None:
    """Ranks of dp index 1 zero their parameters; ``replicate`` must give
    every rank the blocks of the dp-0 rank of its ep coordinate."""
    import torch

    from strom_torch.models import moe
    from strom_torch.parallel import train

    model = moe.MoE(_cfg(moe, 1.25), device="cpu",
                    generator=torch.Generator().manual_seed(5))
    model.shard_(mesh)
    if mesh.axis_index("dp") == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
    train.replicate(model, mesh)
    np.savez(os.path.join(d, f"replicate_rank{r}.npz"),
             **{k: v.detach().numpy() for k, v in model.named_parameters()})


def _worker(argv) -> None:
    from strom_torch.parallel import mesh as pmesh

    r, world, d = gloo_ranks.join(argv)
    meshes = {}
    for cid, (axes, *_) in CASES.items():
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = pmesh.make_mesh(axes)
        _case(meshes[key], d, cid, r)
    _replicate(meshes[(("dp", 2), ("ep", 2))], d, r)
    pmesh.shutdown()


# ------------------------------------------------------- the JAX side
def _jax_case(d: str, cid: str):
    """The JAX package's MoE state on the case's mesh, its full parameters
    saved as ``<cid>_init.npz``; returns ``run()``: its steps over the
    global batches (the (loss, grad_norm) curve, the final parameters,
    and each layer's (expert, keep) of the first batch at the initial
    parameters)."""
    import jax
    import jax.numpy as jnp

    from strom.models import moe as jmoe
    from strom.parallel import train as jtrain
    from strom.parallel.mesh import make_mesh
    from strom_torch.models.moe import params_from_jax

    _, axes, attn, sp, cf = CASES[cid]
    cfg = _cfg(jmoe, cf)
    opt = jtrain.make_optimizer(lr=gloo_ranks.LR, warmup=gloo_ranks.WARMUP)
    mesh = make_mesh(axes, devices=jax.devices()[:WORLD])
    init = jtrain.init_moe_train_state(jax.random.PRNGKey(0), cfg, mesh, opt)
    step = jtrain.make_moe_train_step(cfg, mesh, opt, attn=attn, sp=sp,
                                      donate=False)

    def as_numpy(params):
        return {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)).items()}

    np.savez(os.path.join(d, f"{cid}_init.npz"), **as_numpy(init.params))

    def routes(params, tokens):
        """Each layer's routing of the global batch, through the
        reference's blocks run one by one with its moe_ffn wrapped."""
        got, ffn = [], jmoe.moe_ffn

        def recording(h, lp, c):
            n = h.shape[0] * h.shape[1]
            dispatch, _, _ = jmoe.switch_route(h.reshape(n, -1), lp["router"],
                                               c.capacity(n))
            logits = h.reshape(n, -1).astype(jnp.float32) @ lp["router"]
            got.append((np.asarray(jnp.argmax(jax.nn.softmax(logits), -1)),
                        np.asarray(dispatch.sum((1, 2))) > 0))
            return ffn(h, lp, c)

        params = jax.tree_util.tree_map(np.asarray, params)
        x = jnp.asarray(params["embed"])[tokens].astype(cfg.base.jdtype)
        positions = jnp.broadcast_to(jnp.arange(L), (B, L))
        jmoe.moe_ffn = recording
        try:
            for i in range(cfg.base.n_layers):
                lp = {k: jnp.asarray(v[i]) for k, v in
                      params["layers"].items()}
                x, _ = jmoe.block(x, lp, cfg, positions)
        finally:
            jmoe.moe_ffn = ffn
        return got

    # here, not in run(): the runs share a thread pool, and the module's
    # moe_ffn is patched while routes() runs
    first = routes(init.params, jnp.asarray(_batches()[0]))
    grad = jax.jit(jax.grad(jmoe.next_token_loss), static_argnums=2)

    def run():
        state, curve = init, []
        # lr is 0 at step 0: every step's gradient is taken at init
        grads = [np.asarray(grad(init.params, jnp.asarray(b), cfg)["embed"])
                 for b in _batches()]
        for b in _batches():
            state, m = step(state, b)
            curve.append([float(m["loss"]), float(m["grad_norm"])])
        return np.array(curve), as_numpy(state.params), first, grads

    return run


# --------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks, started once the JAX states exist (their parameters are
    the ranks' start); the JAX steps run while the ranks run."""
    d = str(tmp_path_factory.mktemp("ep_step"))
    runners = {cid: _jax_case(d, cid) for cid in CASES}
    procs = gloo_ranks.start(__file__, WORLD, d)
    with ThreadPoolExecutor(2) as ex:
        futures = {cid: ex.submit(run) for cid, run in runners.items()}
        jax_out = {cid: f.result() for cid, f in futures.items()}
    gloo_ranks.wait(procs)
    return d, jax_out


def _rank(d, cid, r):
    return np.load(os.path.join(d, f"{cid}_rank{r}.npz"))


def _mesh(cid):
    from strom_torch.parallel.mesh import make_mesh

    return make_mesh(CASES[cid][0], devices=range(WORLD))


@pytest.mark.parametrize("cid", list(CASES))
def test_curve_matches_jax(runs, cid):
    d, jax_out = runs
    for r in range(WORLD):
        gloo_ranks.check_curve(_rank(d, cid, r)["curve"], jax_out[cid][0])


@pytest.mark.parametrize("cid", list(CASES))
def test_final_params_match_jax(runs, cid):
    from strom_torch.parallel.train import warmup_cosine

    d, jax_out = runs
    got = _rank(d, cid, 0)
    want, grads = dict(jax_out[cid][1]), jax_out[cid][3]
    g = np.max(np.abs(grads), axis=0)
    quiet = (g > 0) & (g < QUIET_G)
    assert quiet.sum() <= QUIET_MAX
    embed, want_embed = got["full_embed"], want.pop("embed")
    np.testing.assert_allclose(embed[~quiet], want_embed[~quiet], rtol=1e-3,
                               atol=gloo_ranks.PARAM_ATOL["embed"])
    bound = 2 * sum(gloo_ranks.LR * warmup_cosine(t, warmup=gloo_ranks.WARMUP)
                    for t in range(STEPS))
    assert np.abs(embed[quiet] - want_embed[quiet]).max(initial=0) <= bound
    gloo_ranks.check_params({k: got[f"full_{k}"] for k in want}, want)


@pytest.mark.parametrize("cid", list(CASES))
def test_replicas_and_ep_blocks_bit_equal(runs, cid):
    """The gathered parameters are the same on every rank; each rank's
    blocks (its experts, the replicated rest) equal those of the first
    rank of its ep coordinate."""
    d, _ = runs
    mesh = _mesh(cid)
    ranks = [_rank(d, cid, r) for r in range(WORLD)]

    def ep_of(r):
        if "ep" not in mesh.axis_names:
            return 0
        return mesh.coords(r)[mesh.axis_names.index("ep")]

    for r in range(1, WORLD):
        twin = min(s for s in range(WORLD) if ep_of(s) == ep_of(r))
        for k in ranks[r].files:
            if k.startswith("full_"):
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k], k)
            elif not k.startswith(("curve", "expert", "keep")):
                np.testing.assert_array_equal(ranks[r][k], ranks[twin][k], k)
                if k not in ("w_gate", "w_up", "w_down"):
                    np.testing.assert_array_equal(ranks[r][k], ranks[0][k], k)


@pytest.mark.parametrize("cid", list(CASES))
def test_global_capacity_queue(runs, cid):
    """Every rank keeps, in every layer, exactly the tokens of its block
    that the reference keeps when it routes the whole global batch (at
    capacity factor 0.5 every layer drops tokens)."""
    from strom_torch.parallel.sharding import batch_sharding

    d, jax_out = runs
    mesh = _mesh(cid)
    index = batch_sharding(mesh, sp=CASES[cid][3]).devices_indices_map((B, L))
    want = jax_out[cid][2]
    for r in range(WORLD):
        got = _rank(d, cid, r)
        for i, (expert, keep) in enumerate(want):
            keep = keep.reshape(B, L)[index[r]].ravel()
            expert = expert.reshape(B, L)[index[r]].ravel()
            np.testing.assert_array_equal(got[f"keep{i}"], keep,
                                          f"rank {r} layer {i}")
            np.testing.assert_array_equal(got[f"expert{i}"], expert,
                                          f"rank {r} layer {i}")
    if CASES[cid][4] == 0.5:
        for expert, keep in want:
            assert 0 < keep.sum() < B * L


def test_replicate_keeps_each_ep_coordinates_experts(runs):
    d, _ = runs
    mesh = _mesh("dp2ep2_cf125")
    got = [np.load(os.path.join(d, f"replicate_rank{r}.npz"))
           for r in range(WORLD)]
    for r in range(WORLD):
        src = mesh.devices[0, mesh.coords(r)[1]]
        for k in got[r].files:
            np.testing.assert_array_equal(got[r][k], got[src][k], k)
            assert np.abs(got[r][k]).sum() > 0, k
    assert not np.array_equal(got[0]["w_gate"], got[1]["w_gate"])


def test_checkpoint_of_ep_state_raises(runs):
    d, _ = runs
    for r in range(WORLD):
        assert int(_rank(d, "ep4", r)["tree_raised"]) == 1


@pytest.mark.parametrize("axes", [{"tp": 2}, {"pp": 2}, {"ep": 2, "tp": 2},
                                  {"dp": 2, "pp": 2}])
def test_moe_step_refuses_tp_and_pp(axes):
    from strom_torch.models import moe
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.train import make_moe_train_step

    mesh = make_mesh(axes, devices=range(int(np.prod(list(axes.values())))))
    with pytest.raises(NotImplementedError, match="tp or pp"):
        make_moe_train_step(_cfg(moe, 1.25), device="cpu", mesh=mesh)


def test_llama_step_refuses_ep():
    from strom_torch.models import llama
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.train import make_train_step

    mesh = make_mesh({"dp": 2, "ep": 2}, devices=range(4))
    with pytest.raises(NotImplementedError, match="make_moe_train_step"):
        make_train_step(gloo_ranks.tiny_f32(llama), device="cpu", mesh=mesh)


def test_moe_step_checks_experts_divide():
    from strom_torch.models import moe
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.train import make_moe_train_step

    mesh = make_mesh({"ep": 8}, devices=range(8))
    with pytest.raises(ValueError, match="divide by ep"):
        make_moe_train_step(_cfg(moe, 1.25), device="cpu", mesh=mesh)


if __name__ == "__main__":
    _worker(sys.argv)
