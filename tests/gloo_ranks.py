"""A world of gloo ranks on localhost for the port's multi-process tests.

A test file starts one process per rank, each running the file's own
``__main__`` block as ``<file> <rank> <world> <port> <dir>`` (``start``),
computes its JAX reference meanwhile, then waits for every rank to exit 0
(``wait``). Ranks write what they computed under ``<dir>``. Workers
import no JAX: they join the group with ``join`` and use the port alone.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(script: str, world: int, d: str) -> list[subprocess.Popen]:
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(script), str(r), str(world),
         str(port), d], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def wait(procs: list[subprocess.Popen], timeout: float = TIMEOUT_S) -> None:
    """Every rank's exit, each within *timeout*; raises with the output of
    the first that failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{o[-6000:]}")


def join(argv: list[str]) -> tuple[int, int, str]:
    """In a rank's process: join the world its argv names (gloo, a short
    collective timeout) and return (rank, world, dir)."""
    import torch

    from strom_torch.parallel import mesh

    r, world, port = (int(a) for a in argv[1:4])
    torch.set_num_threads(1)
    mesh.init_distributed("cpu", rank=r, world_size=world,
                          init_method=f"tcp://localhost:{port}",
                          timeout_s=TIMEOUT_S / 2)
    return r, world, argv[4]


# ------------------------------------------- the Llama step on a mesh
LR, WARMUP = 1e-2, 2


def tiny_f32(llama):
    """``LlamaConfig.tiny()`` in f32, of either package's llama module."""
    import dataclasses

    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype="float32")


def train_case(mesh, d: str, case: str, batches, *, attn: str, sp: bool,
               rank: int) -> None:
    """In a rank's process: the port's step on *mesh* from
    ``<case>_init.npz``'s full parameters, a step a batch of *batches*:
    global numpy batches, of which each step takes this rank's block, or
    the ``DTensor``s a sharded loader delivered. Writes
    ``<case>_rank<r>.npz``: this rank's parameter blocks, the gathered
    parameters (``full_<name>``) and the (loss, grad_norm) curve."""
    import numpy as np
    import torch

    from strom_torch.models import llama
    from strom_torch.parallel import train
    from strom_torch.parallel.sharding import batch_sharding, gather_params

    cfg = tiny_f32(llama)
    opt = train.make_optimizer(lr=LR, warmup=WARMUP)
    init = np.load(os.path.join(d, f"{case}_init.npz"))
    state = train.init_train_state(
        cfg, opt, device="cpu", mesh=mesh,
        params={k: torch.from_numpy(init[k]) for k in init.files})
    step = train.make_train_step(cfg, opt, attn=attn, device="cpu",
                                 mesh=mesh, sp=sp)
    sh = batch_sharding(mesh, sp=sp)
    curve = []
    for b in batches:
        if isinstance(b, np.ndarray):
            (index,) = sh.addressable_devices_indices_map(b.shape).values()
            b = torch.from_numpy(b[index].copy())
        state, m = step(state, b)
        curve.append([float(m["loss"]), float(m["grad_norm"])])
    local = {k: v.detach() for k, v in state.model.named_parameters()}
    full = gather_params(local, mesh)
    np.savez(os.path.join(d, f"{case}_rank{rank}.npz"),
             curve=np.array(curve), **{k: v.numpy() for k, v in local.items()},
             **{f"full_{k}": v.numpy() for k, v in full.items()})


_JAX_STATES: dict = {}


def jax_case(d: str, case: str, axes: dict, *, attn: str, sp: bool):
    """The JAX package's state on a mesh of *axes* (the conftest's CPU
    devices), its full parameters saved as ``<case>_init.npz``; returns
    ``run(batches)``: its ``make_train_step`` over the global *batches*
    from that state, giving (the (loss, grad_norm) curve, the final full
    parameters)."""
    import jax
    import numpy as np

    from strom.models import llama as jllama
    from strom.parallel import train as jtrain
    from strom.parallel.mesh import make_mesh
    from strom_torch.models.llama import params_from_jax

    cfg = tiny_f32(jllama)
    opt = jtrain.make_optimizer(lr=LR, warmup=WARMUP)
    key = tuple(axes.items())
    if key not in _JAX_STATES:    # one initial state a mesh
        mesh = make_mesh(axes, devices=jax.devices()[:int(np.prod(
            list(axes.values())))])
        _JAX_STATES[key] = mesh, jtrain.init_train_state(
            jax.random.PRNGKey(0), cfg, mesh, opt)
    mesh, init = _JAX_STATES[key]
    step = jtrain.make_train_step(cfg, mesh, opt, attn=attn, sp=sp,
                                  donate=False)

    def as_numpy(params):
        return {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)).items()}

    np.savez(os.path.join(d, f"{case}_init.npz"), **as_numpy(init.params))

    def run(batches):
        state, curve = init, []
        for b in batches:
            state, m = step(state, b)
            curve.append([float(m["loss"]), float(m["grad_norm"])])
        return np.array(curve), as_numpy(state.params)

    return run


# Final parameters against the JAX package's: rtol 1e-3, atol 1e-5 (the
# dp-2 test's), but atol 1e-4 on the embedding. Adam (eps 1e-8) turns an
# embedding gradient that cancels to ~2e-7 into a step of nearly ±lr whose
# size hangs on eps, so f32 summation order moves such an element by up to
# ~1e-4 at lr 1e-2: the JAX package's own meshed and one-device steps end
# 4.36e-5 (dp2sp2 dense, 3 steps) and 2.24e-5 (dp2tp2) apart on the
# embedding, every other leaf within 1.7e-5.
PARAM_ATOL = {"embed": 1e-4}


def check_params(got: dict, want: dict, err: str = "") -> None:
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3,
                                   atol=PARAM_ATOL.get(k, 1e-5),
                                   err_msg=f"{k} {err}")


def check_curve(got, want) -> None:
    """Losses within 1e-4, grad norms within 1e-4 relative (the dp-2
    test's tolerances, ``tests/test_torch_multihost.py``)."""
    assert len(got) == len(want)
    for i, ((tl, tn), (jl, jn)) in enumerate(zip(got, want)):
        assert abs(tl - jl) < 1e-4, (i, tl, jl)
        assert abs(tn - jn) <= 1e-4 * max(1.0, abs(jn)), (i, tn, jn)
