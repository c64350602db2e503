"""Multi-process coordination in the port against the JAX package: the
reference's StragglerMonitor tests, then one world-2 run of real
processes (torch.distributed over gloo on localhost, spawned from this
file's ``__main__`` block) held against the JAX package's dp-2 mesh on the
conftest's CPU devices:

- each rank's local batch of ``make_llama_pipeline(sharding=P("dp",
  None))`` equals the JAX pipeline's shard at the same mesh position, bit
  for bit, over three epochs;
- the rank's engine read exactly its rows' bytes (``bytes_read`` is the
  deliveries' count times one rank's rows);
- ``epoch_sync`` met at both epoch boundaries it crossed;
- ``straggler_report`` lists both ranks;
- two data-parallel steps of ``LlamaConfig.tiny()`` (f32) track
  ``strom.parallel.train.make_train_step`` on the dp-2 mesh at
  ``test_torch_train.py``'s tolerances (losses and grad norms within
  1e-4, parameters rtol 1e-3, atol 1e-5), and the replicas end equal.
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

WORLD, B, SEQ, RECORDS, BATCHES, STEPS = 2, 4, 15, 6, 7, 2
LR, WARMUP = 1e-2, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_f32(llama):
    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype="float32")


# ---------------------------------------------------- the rank's program
def _worker(r: int, port: int, d: str) -> None:
    from strom_torch.config import StromConfig
    from strom_torch.delivery.core import StromContext
    from strom_torch.models import llama as tllama
    from strom_torch.parallel import mesh as tmesh
    from strom_torch.parallel import train as ttrain
    from strom_torch.parallel.sharding import P, TorchSharding, local_tensor
    from strom_torch.pipelines import base
    from strom_torch.pipelines.llama_pretrain import make_llama_pipeline

    torch.set_num_threads(2)
    tmesh.init_distributed("cpu", rank=r, world_size=WORLD,
                           init_method=f"tcp://localhost:{port}")
    mesh = tmesh.make_mesh({"dp": WORLD})
    sharding = TorchSharding(mesh, P("dp", None))
    barriers = []
    real = base.epoch_barrier
    base.epoch_barrier = lambda name: (barriers.append(name), real(name))
    ctx = StromContext(StromConfig(engine="python"))
    eng0 = ctx.engine.stats()["bytes_read"]
    xfer0 = ctx.stats()["context"]["transfers"]
    paths = [os.path.join(d, f"tokens{i}.bin") for i in range(2)]
    pipe = make_llama_pipeline(ctx, paths, batch=B, seq_len=SEQ,
                               sharding=sharding, epoch_sync=True,
                               prefetch_depth=2)
    got = [next(pipe) for _ in range(BATCHES)]
    report = pipe.straggler_report()
    pipe.close()
    out = {"global_shape": [list(g.shape) for g in got],
           "bytes_read": ctx.engine.stats()["bytes_read"] - eng0,
           "transfers": ctx.stats()["context"]["transfers"] - xfer0,
           "barriers": barriers,
           "hosts": [[h.process_index, h.steps] for h in report.hosts]}
    ctx.close()
    cfg = _tiny_f32(tllama)
    init = dict(np.load(os.path.join(d, "init.npz")))
    opt = ttrain.make_optimizer(lr=LR, warmup=WARMUP)
    params = {k: torch.from_numpy(v) for k, v in init.items()}
    if r:   # the broadcast from rank 0 must make the replicas equal
        params = {k: torch.zeros_like(v) for k, v in params.items()}
    state = ttrain.init_train_state(cfg, opt, device="cpu", params=params,
                                    mesh=mesh)
    step = ttrain.make_train_step(cfg, opt, device="cpu", mesh=mesh)
    curve = []
    for b in got[:STEPS]:
        state, m = step(state, b)
        curve.append([float(m["loss"]), float(m["grad_norm"])])
    out["curve"] = curve
    np.savez(os.path.join(d, f"rank{r}.npz"),
             batches=np.stack([local_tensor(g).numpy() for g in got]),
             **{k: v.detach().numpy() for k, v in
                state.model.state_dict().items()})
    with open(os.path.join(d, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    tmesh.shutdown()


# --------------------------------------------------------------- the tests
def test_straggler_monitor_single_process():
    from strom_torch.parallel.multihost import StragglerMonitor

    m = StragglerMonitor()
    for t in (0.01, 0.02, 0.03):
        m.record(t)
    steps, mean, p99 = m.local_stats()
    assert steps == 3
    assert mean == pytest.approx(0.02)
    assert p99 == pytest.approx(0.03)
    rep = m.report()
    assert len(rep.hosts) == 1
    assert rep.hosts[0].steps == 3
    assert rep.stragglers == ()
    assert "p0" in str(rep)


def test_straggler_monitor_context_manager():
    import time

    from strom_torch.parallel.multihost import StragglerMonitor

    m = StragglerMonitor()
    with m.step():
        time.sleep(0.005)
    steps, mean, _ = m.local_stats()
    assert steps == 1
    assert mean >= 0.004


def test_straggler_monitor_empty():
    from strom_torch.parallel.multihost import StragglerMonitor

    m = StragglerMonitor()
    assert m.local_stats() == (0, 0.0, 0.0)
    rep = m.report()
    assert rep.hosts[0].steps == 0
    assert rep.stragglers == ()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_reference(d: str, paths: list[str]):
    """The JAX package's shards of the same batches at each dp-2 position,
    and its dp-2 train curve from the parameters the ranks start from."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from strom.config import StromConfig
    from strom.delivery.core import StromContext
    from strom.models import llama as jllama
    from strom.parallel import train as jtrain
    from strom.parallel.mesh import make_mesh
    from strom.pipelines import make_llama_pipeline
    from strom_torch.models import llama as tllama

    devs = jax.devices()[:WORLD]
    mesh = make_mesh({"dp": WORLD}, devices=devs)
    sharding = NamedSharding(mesh, JP("dp", None))
    ctx = StromContext(StromConfig(engine="python"))
    try:
        with make_llama_pipeline(ctx, paths, batch=B, seq_len=SEQ,
                                 sharding=sharding, prefetch_depth=2) as pipe:
            batches = [next(pipe) for _ in range(BATCHES)]
    finally:
        ctx.close()
    shards = [[np.asarray(next(s.data for s in g.addressable_shards
                               if s.device == dev)) for g in batches]
              for dev in devs]
    jcfg = _tiny_f32(jllama)
    opt = jtrain.make_optimizer(lr=LR, warmup=WARMUP)
    state = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, mesh, opt)
    init = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         state.params))
    np.savez(os.path.join(d, "init.npz"),
             **{k: v.numpy() for k, v in init.items()})
    step = jtrain.make_train_step(jcfg, mesh, opt, donate=False)
    curve = []
    for g in batches[:STEPS]:
        state, m = step(state, g)
        curve.append([float(m["loss"]), float(m["grad_norm"])])
    final = tllama.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          state.params))
    return shards, curve, {k: v.numpy() for k, v in final.items()}


def test_world_two_matches_jax_dp2(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"tokens{i}.bin"))
        # ids below LlamaConfig.tiny().vocab, so the batches feed the step
        rng.integers(0, 512, (RECORDS, SEQ + 1), dtype=np.int32).tofile(
            paths[-1])
    shards, jcurve, jfinal = _jax_reference(str(tmp_path), paths)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         str(tmp_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
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
        with open(tmp_path / f"rank{r}.json") as f:
            out = json.load(f)
        arrs = dict(np.load(tmp_path / f"rank{r}.npz"))
        # this rank's rows, bit for bit, at every batch over three epochs
        np.testing.assert_array_equal(arrs.pop("batches"),
                                      np.stack(shards[r]))
        assert out["global_shape"] == [[B, SEQ + 1]] * BATCHES
        # the engine read this rank's rows and nothing else
        assert out["transfers"] >= BATCHES
        assert out["bytes_read"] == out["transfers"] * rows * (SEQ + 1) * 4
        # epochs of 3 batches: the boundaries before batches 3 and 6
        assert out["barriers"] == ["strom-epoch-1", "strom-epoch-2"]
        assert [h[0] for h in out["hosts"]] == list(range(WORLD))
        assert all(h[1] == BATCHES - 1 for h in out["hosts"])
        for i, ((jl, jn), (tl, tn)) in enumerate(zip(jcurve, out["curve"])):
            assert abs(tl - jl) < 1e-4, (r, i, tl, jl)
            assert abs(tn - jn) <= 1e-4 * max(1.0, jn), (r, i, tn, jn)
        for k, v in jfinal.items():
            np.testing.assert_allclose(arrs[k], v, rtol=1e-3, atol=1e-5,
                                       err_msg=k)
        finals.append(arrs)
    for k in finals[0]:   # the replicas are bit-equal
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
