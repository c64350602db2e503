"""The shapes the CUDA flash kernels took on only after the reference's:
head dims below 64, heads wider than 128, and seq lens off the kernels'
64-row tile.

The wrappers zero-pad a head of Dh < 64 (or 64 < Dh < 128, or above 128
to a multiple of 128) to the kernels' width and slice the outputs back, with the scale kept at 1/sqrt(Dh): here
the plain versions run through that padding and slicing must equal the
plain versions on the unpadded inputs, forward and backward. Zero columns
add exact zeros to every dot product, so the two differ only where f32
sums over the longer rows are grouped differently: 1e-6 of the largest
value. A ragged S runs the kernels' masked last tile; on the CPU the port's
plain versions at such S (Dh 32 and 48, one block of S rows where 64
does not divide S, as the reference requires) are held to
the JAX Pallas kernels in interpret mode at the tolerances of
tests/test_torch_flash_attention.py. The kernels themselves are held to the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strom_torch.ops import flash_attention as tfa

jfa = importlib.import_module("strom.ops.flash_attention")

PAD_TOL = 1e-6
FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(seed, B, S, H, KV, Dh):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh),
                      (B, S, H, Dh))]


@pytest.mark.parametrize("Dh,width", [(32, 64), (48, 64), (96, 128),
                                      (64, 64), (128, 128)])
def test_kernel_head_dim(Dh, width):
    assert tfa.kernel_head_dim(Dh) == width
    t = torch.ones(2, 3, Dh)
    p = tfa.pad_head(t, width)
    assert p.shape == (2, 3, width) and p.is_contiguous()
    assert (p[..., :Dh] == 1).all() and (p[..., Dh:] == 0).all()
    assert tfa.pad_head(t, Dh) is t


@pytest.mark.parametrize("Dh,width", [(129, 256), (160, 256), (192, 256),
                                      (256, 256), (257, 384), (320, 384),
                                      (512, 512), (513, 640)])
def test_kernel_head_dim_wide(Dh, width):
    """Above 128 a head pads to the next multiple of 128, the scalar
    kernels' chunk: no head dim is refused."""
    assert tfa.kernel_head_dim(Dh) == width
    assert width % tfa.WIDE_CHUNK == 0 and width - Dh < tfa.WIDE_CHUNK


@pytest.mark.parametrize("Dh", [0, -1])
def test_kernel_head_dim_refuses_empty_heads(Dh):
    with pytest.raises(ValueError, match="positive"):
        tfa.kernel_head_dim(Dh)


@pytest.mark.parametrize("kernel", ["fa_fwd", "fa_bwd_dkv", "fa_bwd_dq"])
@pytest.mark.parametrize("Dh", [32, 64, 96, 128, 160, 192, 256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_route(dtype, Dh, kernel):
    """Which library launches each kernel, at the width the wrappers pad
    *Dh* to: bf16 up to 256 (padded to 64, 128 or 256) runs the wgmma
    kernels for all three; f32 at every head and bf16 above 256 the
    scalar kernels."""
    wgmma = dtype == torch.bfloat16 and Dh <= 256
    route = tfa.kernel_route(kernel, dtype, tfa.kernel_head_dim(Dh))
    assert route == ("sm90" if wgmma else "scalar")


@pytest.mark.parametrize("rc", [0, -1])
@pytest.mark.parametrize("library, dtype, key", [
    ("sm90", torch.bfloat16, "fa_bwd_dkv@sm90/bf16"),
    ("scalar", torch.float32, "fa_bwd_dkv@scalar/f32")])
def test_launch_counts_by_variant(library, dtype, key, rc):
    """A launch counts once under the kernel's name and once under its
    variant (kernel, library, dtype); a launch the library refuses raises
    and counts nothing; reset_launch_counts zeroes both. A stand-in
    launcher returns *rc* (0: launched; -1: unsupported width)."""
    saved = (dict(tfa.LAUNCHES), dict(tfa.VARIANT_LAUNCHES))
    tfa.reset_launch_counts()
    try:
        if rc:
            with pytest.raises(RuntimeError, match="unsupported"):
                tfa._launch("fa_bwd_dkv", library, dtype, lambda *a: rc, 256)
        else:
            tfa._launch("fa_bwd_dkv", library, dtype, lambda *a: rc, 256)
        assert dict(tfa.LAUNCHES) == {"fa_fwd": 0, "fa_bwd_dq": 0,
                                      "fa_bwd_dkv": 0 if rc else 1}
        assert dict(tfa.VARIANT_LAUNCHES) == ({} if rc else {key: 1})
        assert tfa.variant("fa_bwd_dkv", library, dtype) == key
        tfa.reset_launch_counts()
        assert not any(tfa.LAUNCHES.values()) and not tfa.VARIANT_LAUNCHES
    finally:
        for counter, values in zip((tfa.LAUNCHES, tfa.VARIANT_LAUNCHES),
                                   saved):
            counter.clear()
            counter.update(values)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("Dh", [160, 256, 320])
def test_wide_heads_match_jax_flash(Dh, S, causal):
    """out, lse and the gradients of sum(out**2) at heads wider than 128
    (B 1, H 2, KV 1, 64-row blocks), the port's plain versions against the
    Pallas kernels in interpret mode, at the tolerances of
    tests/test_torch_flash_attention.py."""
    q, k, v, _ = _inputs(3 * S + Dh, 1, S, 2, 1, Dh)
    block = 64
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    jout, jlse = jfa._flash_fwd(jq, jk, jv, causal=causal, block_q=block,
                                block_k=block, interpret=True)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jfa.flash_attention(
        a, b, c, causal, block, block) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, block, block)
    (out ** 2).sum().backward()
    _, lse = tfa._flash_fwd(q, k, v, causal=causal, block_q=block,
                            block_k=block)
    for name, got, want, tol in zip(
            ("out", "lse", "dq", "dk", "dv"),
            (out.detach(), lse, tq.grad, tk.grad, tv.grad),
            (jout, jlse, *jgrads),
            (FWD_TOL, FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dh", [160, 320])
def test_wide_padded_plain_equals_unpadded(Dh, causal):
    """The wrappers' padding at wide heads (160 to 256, 320 to 384), with
    the plain versions in the kernels' place, equals the unpadded plain
    versions within PAD_TOL."""
    q, k, v, g = _inputs(Dh, 1, 128, 2, 1, Dh)
    width = tfa.kernel_head_dim(Dh)
    blk = dict(causal=causal, block_q=64, block_k=64)
    out, lse = tfa._flash_fwd_plain(q, k, v, **blk)
    grads = tfa._flash_bwd_plain(q, k, v, g, lse, tfa._delta(out, g), **blk)
    qp, kp, vp, gp = (tfa.pad_head(t, width) for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(Dh)
    pout, plse = tfa._flash_fwd_plain(qp, kp, vp, scale=scale, **blk)
    pgrads = tfa._flash_bwd_plain(qp, kp, vp, gp, plse, tfa._delta(pout, gp),
                                  scale=scale, **blk)
    torch.testing.assert_close(plse, lse, rtol=0, atol=PAD_TOL)
    for got, want in zip((pout, *pgrads), (out, *grads)):
        assert (got[..., Dh:] == 0).all()
        torch.testing.assert_close(got[..., :Dh], want, rtol=0,
                                   atol=PAD_TOL * want.abs().max().item())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [128, 96, 63])
@pytest.mark.parametrize("Dh", [32, 48])
def test_padded_plain_equals_unpadded(Dh, S, causal):
    """What the kernel wrappers do around a launch, with the plain versions
    in the kernels' place: pad q, k, v and dO to the kernel width, run at
    scale 1/sqrt(Dh), slice out, dq, dk and dv back."""
    q, k, v, g = _inputs(Dh + S, 1, S, 4, 2, Dh)
    width = tfa.kernel_head_dim(Dh)
    block = S if S % 64 else 64
    blk = dict(causal=causal, block_q=block, block_k=block)
    out, lse = tfa._flash_fwd_plain(q, k, v, **blk)
    delta = tfa._delta(out, g)
    grads = tfa._flash_bwd_plain(q, k, v, g, lse, delta, **blk)

    qp, kp, vp, gp = (tfa.pad_head(t, width) for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(Dh)
    pout, plse = tfa._flash_fwd_plain(qp, kp, vp, scale=scale, **blk)
    pdelta = tfa._delta(pout, gp)
    pgrads = tfa._flash_bwd_plain(qp, kp, vp, gp, plse, pdelta, scale=scale,
                                  **blk)
    assert (pout[..., Dh:] == 0).all()
    assert all((x[..., Dh:] == 0).all() for x in pgrads)
    torch.testing.assert_close(plse, lse, rtol=0, atol=PAD_TOL)
    torch.testing.assert_close(pdelta, delta, rtol=0,
                               atol=PAD_TOL * delta.abs().max().item())
    for got, want in zip((pout, *pgrads), (out, *grads)):
        torch.testing.assert_close(got[..., :Dh], want, rtol=0,
                                   atol=PAD_TOL * want.abs().max().item())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [63, 96])
@pytest.mark.parametrize("Dh", [32, 48])
def test_ragged_seq_matches_jax_flash(Dh, S, causal):
    """out, lse and the gradients of sum(out**2) at a ragged S, against the
    Pallas kernels in interpret mode, both with one block of S rows."""
    q, k, v, _ = _inputs(7 * S + Dh, 1, S, 4, 2, Dh)
    block = S
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    jout, jlse = jfa._flash_fwd(jq, jk, jv, causal=causal, block_q=block,
                                block_k=block, interpret=True)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jfa.flash_attention(
        a, b, c, causal, block, block) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, block, block)
    (out ** 2).sum().backward()
    _, lse = tfa._flash_fwd(q, k, v, causal=causal, block_q=block,
                            block_k=block)
    for name, got, want, tol in zip(
            ("out", "lse", "dq", "dk", "dv"),
            (out.detach(), lse, tq.grad, tk.grad, tv.grad),
            (jout, jlse, *jgrads),
            (FWD_TOL, FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol, err_msg=name)
