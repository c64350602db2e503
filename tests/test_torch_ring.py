"""Ring attention in the port (``strom_torch/parallel/ring.py``) against
the JAX package's (``strom/parallel/ring.py``), the cases of
``tests/test_ring.py``: the dense, flash and zigzag rings, causal and not,
forward and the gradients of ``sum(out · w)`` in q, k and v, at
(B, S, H, KV, Dh) = (2, 64, 4, 2, 16) and (1, 32, 4, 4, 8), over sp 4 and
sp 2 (beside a tp axis of 2 that splits the heads), and zigzag over an odd
ring of 3. The port runs one gloo process a rank (this file's ``__main__``
block), each on its block of the inputs, the flash rings on the kernels'
plain versions; the JAX side runs ``make_ring_attention`` on the
conftest's CPU devices (Pallas in interpret mode). Tolerance 2e-4
(relative and absolute) in f32, as the reference's tests use.

Also ``ppermute``'s forward and its backward (the inverse permutation),
a self-send among them, and the refusals: zigzag of non-causal attention
and of an odd local length.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import gloo_ranks

TOL = 2e-4
A, B_ = (2, 64, 4, 2, 16), (1, 32, 4, 4, 8)
SP4, TP2SP2, SP3 = {"sp": 4}, {"tp": 2, "sp": 2}, {"sp": 3}
# id: (mesh axes, impl, causal, (B, S, H, KV, Dh))
CASES = {
    "dense_a": (SP4, "dense", True, A),
    "dense_b": (SP4, "dense", True, B_),
    "dense_sp2": (TP2SP2, "dense", True, A),
    "dense_noncausal": (TP2SP2, "dense", False, (1, 32, 2, 2, 8)),
    "flash_a": (SP4, "flash", True, A),
    "flash_b": (SP4, "flash", True, B_),
    "flash_sp2": (TP2SP2, "flash", True, B_),
    "flash_noncausal": (TP2SP2, "flash", False, A),
    "flash_noncausal_sp4": (SP4, "flash", False, B_),
    "zigzag_a": (SP4, "zigzag", True, A),
    "zigzag_b": (SP4, "zigzag", True, B_),
    "zigzag_sp2": (TP2SP2, "zigzag", True, A),
    "zigzag_odd": (SP3, "zigzag", True, (1, 48, 4, 2, 8)),
}
PERMS = {"shift2": [(0, 2), (1, 0), (2, 3), (3, 1)],
         "fixed0": [(0, 0), (1, 3), (2, 1), (3, 2)]}


def _spec(axes):
    from strom_torch.parallel.sharding import P

    return P(None, "sp", "tp" if "tp" in axes else None, None)


def _inputs(case_id):
    _, _, _, (B, S, H, KV, Dh) = CASES[case_id]
    rng = np.random.default_rng(sorted(CASES).index(case_id))
    return {"q": rng.normal(size=(B, S, H, Dh)).astype(np.float32),
            "k": rng.normal(size=(B, S, KV, Dh)).astype(np.float32),
            "v": rng.normal(size=(B, S, KV, Dh)).astype(np.float32),
            "w": rng.normal(size=(B, S, H, Dh)).astype(np.float32)}


def _world(axes) -> int:
    return int(np.prod(list(axes.values())))


# ---------------------------------------------------- the rank's program
def _worker(argv) -> None:
    from strom_torch.parallel import mesh as pmesh
    from strom_torch.parallel.ring import make_ring_attention, ppermute
    from strom_torch.parallel.sharding import TorchSharding

    r, world, d = gloo_ranks.join(argv)
    meshes = {}
    for cid, (axes, impl, causal, shape) in CASES.items():
        if _world(axes) != world:
            continue
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = pmesh.make_mesh(axes)
        mesh = meshes[key]
        sh = TorchSharding(mesh, _spec(axes))
        local = {}
        for name, full in _inputs(cid).items():
            (index,) = sh.addressable_devices_indices_map(full.shape).values()
            local[name] = torch.from_numpy(full[index].copy())
        q, k, v = (local[n].requires_grad_(True) for n in "qkv")
        out = make_ring_attention(mesh, impl=impl, causal=causal)(q, k, v)
        (out * local["w"]).sum().backward()
        np.savez(os.path.join(d, f"{cid}_rank{r}.npz"),
                 out=out.detach().numpy(), dq=q.grad.numpy(),
                 dk=k.grad.numpy(), dv=v.grad.numpy())
    if world == 4:
        axis = meshes[tuple(SP4.items())].axis("sp")
        for pid, perm in PERMS.items():
            x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
            x.requires_grad_(True)
            w = torch.full((2, 3), float(r + 1))
            y = ppermute(x, perm, axis)
            (y * w).sum().backward()
            np.savez(os.path.join(d, f"perm_{pid}_rank{r}.npz"),
                     y=y.detach().numpy(), dx=x.grad.numpy())
    pmesh.shutdown()


# --------------------------------------------------------------- the tests
def _jax_ring(case_id):
    """The JAX package's ring on the same global inputs: out and the
    gradients of sum(out · w)."""
    import jax
    import jax.numpy as jnp

    from strom.parallel.mesh import make_mesh
    from strom.parallel.ring import make_ring_attention

    axes, impl, causal, _ = CASES[case_id]
    x = {k: jnp.asarray(v) for k, v in _inputs(case_id).items()}
    mesh = make_mesh(axes, devices=jax.devices()[:_world(axes)])
    ring = make_ring_attention(mesh, impl=impl, causal=causal)

    @jax.jit
    def run(q, k, v, w):
        out, vjp = jax.vjp(ring, q, k, v)
        return (out, *vjp(w))

    return dict(zip(("out", "dq", "dk", "dv"),
                    (np.asarray(t) for t in run(x["q"], x["k"], x["v"],
                                                x["w"]))))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Both worlds' ranks (4, then the odd ring of 3), started at once;
    the JAX references computed while they run."""
    d = str(tmp_path_factory.mktemp("ring"))
    procs = [gloo_ranks.start(__file__, w, d) for w in (4, 3)]
    # XLA compiles dominate: two at a time
    with ThreadPoolExecutor(2) as ex:
        jax_out = dict(zip(CASES, ex.map(_jax_ring, CASES)))
    for p in procs:
        gloo_ranks.wait(p)
    return d, jax_out


def _assemble(d, case_id, key):
    """The global array from every rank's block of it."""
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.sharding import TorchSharding

    axes, _, _, _ = CASES[case_id]
    full = _inputs(case_id)["q" if key in ("out", "dq") else "k"]
    sh = TorchSharding(make_mesh(axes, devices=range(_world(axes))),
                       _spec(axes))
    out = np.full(full.shape, np.nan, np.float32)
    for r, index in sh.devices_indices_map(full.shape).items():
        out[index] = np.load(os.path.join(d, f"{case_id}_rank{r}.npz"))[key]
    return out


@pytest.mark.parametrize("key", ["out", "dq", "dk", "dv"])
@pytest.mark.parametrize("case_id", list(CASES))
def test_ring_matches_jax(port_runs, case_id, key):
    d, jax_out = port_runs
    got = _assemble(d, case_id, key)
    np.testing.assert_allclose(got, jax_out[case_id][key], rtol=TOL,
                               atol=TOL, err_msg=f"{case_id} {key}")


@pytest.mark.parametrize("pid", list(PERMS))
def test_ppermute_and_its_backward(port_runs, pid):
    """y on d is x of s for each (s, d); the gradient of x on s is w of d:
    the inverse permutation."""
    d, _ = port_runs
    runs = [np.load(os.path.join(d, f"perm_{pid}_rank{r}.npz"))
            for r in range(4)]
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
         for r in range(4)]
    for s, dst in PERMS[pid]:
        np.testing.assert_array_equal(runs[dst]["y"], x[s])
        np.testing.assert_array_equal(runs[s]["dx"],
                                      np.full((2, 3), float(dst + 1)))


def test_zigzag_refuses_non_causal():
    import jax

    from strom.parallel.mesh import make_mesh as jmesh
    from strom.parallel.ring import make_ring_attention as jring
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.ring import make_ring_attention

    with pytest.raises(ValueError, match="zigzag balances the CAUSAL"):
        make_ring_attention(make_mesh({"sp": 1}), impl="zigzag",
                            causal=False)
    with pytest.raises(ValueError, match="zigzag balances the CAUSAL"):
        jring(jmesh({"sp": 2}, devices=jax.devices()[:2]), impl="zigzag",
              causal=False)


def test_zigzag_refuses_odd_local_length():
    from strom_torch.parallel.mesh import AxisGroup
    from strom_torch.parallel.ring import zigzag_ring_flash_local

    q = torch.zeros(1, 7, 2, 8)
    with pytest.raises(ValueError, match="even per-device sequence length"):
        zigzag_ring_flash_local(q, q, q, AxisGroup("sp", 0, 2, (0, 1)))


def test_unknown_impl_and_shared_axes_raise():
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.ring import make_ring_attention

    mesh = make_mesh({"sp": 1})
    with pytest.raises(ValueError, match="impl must be"):
        make_ring_attention(mesh, impl="sparse")
    with pytest.raises(ValueError, match="also the batch or head axis"):
        make_ring_attention(mesh, axis="sp", head_axis="sp")


def test_one_process_ring_is_flash_attention():
    """A ring of one: every impl equals the single-process attention."""
    from strom_torch.models.llama import attention
    from strom_torch.parallel.mesh import make_mesh
    from strom_torch.parallel.ring import make_ring_attention

    x = {k: torch.from_numpy(v) for k, v in _inputs("flash_a").items()}
    ref = attention(x["q"], x["k"], x["v"])
    for impl in ("dense", "flash", "zigzag"):
        out = make_ring_attention(make_mesh({"sp": 1}), impl=impl)(
            x["q"], x["k"], x["v"])
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


if __name__ == "__main__":
    _worker(sys.argv)
