"""The PyTorch port's flash attention against the JAX Pallas kernels (run in
interpret mode on the CPU, as tests/test_flash_attention.py runs them) and
against the dense oracle: out, lse, dq, dk and dv, from the same numpy
inputs. On the CPU the port runs its kernels' plain versions; the CUDA
kernels themselves are compared with those plain versions on the card by
tests/test_torch_cuda.py and by chip_smoke.py.

Tolerances are those of tests/test_flash_attention.py: 2e-5 for the forward
(f32 sums in another order), 1e-4 for the gradients (three chained f32
products per element)."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strom_torch.ops import flash_attention as tfa

# the module, not the function strom.ops re-exports under the same name
jfa = importlib.import_module("strom.ops.flash_attention")

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _qkv(seed, B, S, H, KV, Dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    return q, k, v


def _jax_all(q, k, v, causal, block):
    """JAX flash out, lse and the grads of sum(out**2)."""
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jfa._flash_fwd(jq, jk, jv, causal=causal, block_q=block,
                              block_k=block, interpret=True)
    grads = jax.grad(lambda a, b, c: jnp.sum(jfa.flash_attention(
        a, b, c, causal, block, block) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
    return [np.asarray(x) for x in (out, lse, *grads)]


def _torch_all(q, k, v, causal, block):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, block, block)
    (out ** 2).sum().backward()
    _, lse = tfa._flash_fwd(tq.detach(), tk.detach(), tv.detach(),
                            causal=causal, block_q=block, block_k=block)
    return [x.detach().numpy() for x in (out, lse, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,Dh,block", [
    (2, 256, 4, 2, 128, 128),   # GQA, 2x2 blocks
    (1, 128, 2, 2, 64, 64),     # MHA, head dim 64, 2x2 blocks
    (1, 128, 4, 1, 64, 128),    # MQA, one block
])
def test_matches_jax_flash(causal, B, S, H, KV, Dh, block):
    q, k, v = _qkv(0, B, S, H, KV, Dh)
    want = _jax_all(q, k, v, causal, block)
    got = _torch_all(q, k, v, causal, block)
    for name, g, w, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                               (FWD_TOL, FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_dense_oracle(causal):
    """Against the f32 dense attention, torch's and JAX's oracles alike,
    with the gradients of the dense op by autograd."""
    q, k, v = _qkv(1, 2, 256, 4, 2, 64)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, 64, 64)
    (out ** 2).sum().backward()
    flash_grads = [t.grad.clone() for t in (tq, tk, tv)]
    for t in (tq, tk, tv):
        t.grad = None
    ref = tfa._dense_ref(tq, tk, tv, causal)
    (ref ** 2).sum().backward()
    jref = np.asarray(jfa._dense_ref(*map(jnp.asarray, (q, k, v)), causal))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(ref.detach().numpy(), jref, rtol=FWD_TOL,
                               atol=FWD_TOL)
    for name, g, t in zip(("dq", "dk", "dv"), flash_grads, (tq, tk, tv)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_matches_model_attention():
    from strom_torch.models.llama import attention

    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 1, 128, 4, 2, 128))
    np.testing.assert_allclose(
        tfa.flash_attention(q, k, v, True, 64, 64).numpy(),
        attention(q, k, v, causal=True).numpy(), rtol=FWD_TOL, atol=FWD_TOL)


def test_blocked_vs_single_block():
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _qkv(3, 1, 256, 2, 2, 64))
    res = []
    for blocks in ((64, 128), (256, 256)):
        out = tfa.flash_attention(q, k, v, True, *blocks)
        res.append([out.detach()] + list(torch.autograd.grad(
            (out ** 2).sum(), (q, k, v))))
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_explicit_delta_is_the_vjp():
    """_flash_bwd with an explicit (lse, delta) — the ring-attention
    block-pair contract — equals the default delta=None backward."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 128, 4, 2, 64))
    g = torch.from_numpy(_qkv(5, 1, 128, 4, 2, 64)[0])
    out, lse = tfa._flash_fwd(q, k, v, causal=True)
    a = tfa._flash_bwd(q, k, v, out, lse, g, causal=True)
    b = tfa._flash_bwd(q, k, v, None, lse, g, causal=True,
                       delta=tfa._delta(out, g))
    assert tfa._delta(out, g).shape == (1, 4, 128, 1)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_ragged_seq_rejected():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 100, 2, 2, 128))
    with pytest.raises(ValueError, match="must divide"):
        tfa.flash_attention(q, k, v, True, 64, 64)


def test_mismatched_shapes_rejected():
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 1, 128, 3, 2, 64))
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention(q, k, v)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers never run the plain version: a CPU tensor, an
    unsupported head width or a seq len off the 64-row tile raises."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 1, 128, 2, 2, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._flash_fwd_kernel(q, k, v, causal=True)
    q32, k32, v32 = (torch.from_numpy(x) for x in _qkv(8, 1, 128, 2, 2, 32))
    with pytest.raises(ValueError, match="head dims"):
        tfa._flash_fwd_kernel(q32, k32, v32, causal=True)
    q96, k96, v96 = (torch.from_numpy(x) for x in _qkv(8, 1, 96, 2, 2, 64))
    with pytest.raises(ValueError, match="divisible by 64"):
        tfa._flash_fwd_kernel(q96, k96, v96, causal=True)
    lse = torch.zeros(1, 2, 128, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._flash_bwd_kernel(q, k, v, q, lse, lse, causal=True)


def test_cpu_path_launches_no_kernel():
    tfa.reset_launch_counts()
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _qkv(9, 1, 128, 2, 2, 64))
    tfa.flash_attention(q, k, v).sum().backward()
    assert dict(tfa.LAUNCHES) == {"fa_fwd": 0, "fa_bwd_dkv": 0, "fa_bwd_dq": 0}


def test_bf16_plain_version_tracks_f32():
    """bf16 inputs: the plain version rounds P to v's dtype before P·V, as
    the Pallas kernel does; it stays within bf16 noise of the f32 result."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, 1, 128, 4, 2, 64))
    f32, _ = tfa._flash_fwd(q, k, v, causal=True)
    b16, lse = tfa._flash_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                              causal=True)
    assert b16.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(b16.float().numpy(), f32.numpy(), rtol=0,
                               atol=3e-2)
