"""The one operand preparation both flash launch sites use
(``kernel_operands``): the forward's and the backward kernels' inputs
zero-padded to the kernel's head width, lse and Δ as rows of S rounded up
to the 64-row tile, and every one of them 16-byte aligned, since the sm90
kernels read through TMA maps and bulk copies and the scalar ones by
16-byte cp.async. Here on CPU tensors: a contiguous view 4 bytes into its
storage comes back aligned with equal values, and a tensor that already
fits comes back as the same object (the main path gains no copy). The
kernels themselves take such views on the card
(tests/test_torch_cuda.py::test_kernels_take_unaligned_inputs)."""

import numpy as np
import pytest
import torch

from strom_torch.ops import flash_attention as tfa


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of *t* that starts 4 bytes into its storage."""
    skip = 4 // t.element_size()
    flat = torch.empty(t.numel() + skip, dtype=t.dtype)[skip:]
    return flat.view(t.shape).copy_(t)


def _operands(dtype, S, Dh, seed=0):
    """Seeded q, k, v, dO [B,S,H|KV,Dh] and lse, Δ [B,H,S,1] (f32)."""
    rng = np.random.default_rng(seed)
    B, H, KV = 2, 4, 2
    typed = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .to(dtype) for s in ((B, S, H, Dh), (B, S, KV, Dh),
                                       (B, S, KV, Dh), (B, S, H, Dh)))
    rows = tuple(torch.from_numpy(rng.normal(size=(B, H, S, 1))
                                  .astype(np.float32)) for _ in range(2))
    return typed, rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,S", [(64, 128), (128, 128), (256, 192),
                                  (96, 128), (48, 63), (320, 96)])
def test_kernel_operands_align_shifted_views(dtype, Dh, S):
    """Views 4 bytes off alignment come back 16-byte aligned and
    contiguous, with the values of the inputs: q, k, v and dO zero-padded
    to kernel_head_dim(Dh), lse and Δ as [B,H,SL] rows, SL = S rounded up
    to 64, zeros past S."""
    typed, rows = _operands(dtype, S, Dh)
    shifted_typed = tuple(_shifted(t) for t in typed)
    shifted_rows = tuple(_shifted(t) for t in rows)
    assert all(t.data_ptr() % 16 == 4 and t.is_contiguous()
               for t in shifted_typed + shifted_rows)
    width = tfa.kernel_head_dim(Dh)
    got_typed, got_rows, SL = tfa.kernel_operands(width, shifted_typed,
                                                  shifted_rows)
    assert SL == -(-S // 64) * 64 and SL % 64 == 0 and SL >= S
    for got, want in zip(got_typed, typed):
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert got.dtype == want.dtype
        assert got.shape == (*want.shape[:-1], width)
        assert torch.equal(got[..., :Dh], want)
        assert (got[..., Dh:] == 0).all()
    for got, want in zip(got_rows, rows):
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        B, H = want.shape[:2]
        flat = got.reshape(B, H, SL)
        assert torch.equal(flat[..., :S], want.reshape(B, H, S))
        assert (flat[..., S:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,S", [(64, 128), (128, 64), (256, 192),
                                  (512, 2048)])
def test_kernel_operands_copy_nothing_that_fits(dtype, Dh, S):
    """Aligned inputs at a kernel width, with S a multiple of 64, come
    back as the very same tensors: the main path's operands are not
    copied. The forward passes no rows."""
    typed, rows = _operands(dtype, S, Dh, seed=1)
    assert tfa.kernel_head_dim(Dh) == Dh
    assert all(t.data_ptr() % 16 == 0 for t in typed + rows)
    got_typed, got_rows, SL = tfa.kernel_operands(Dh, typed, rows)
    assert SL == S
    assert all(a is b for a, b in zip(got_typed + got_rows, typed + rows))
    fwd_typed, fwd_rows, _ = tfa.kernel_operands(Dh, typed[:3])
    assert fwd_rows == () and all(a is b for a, b in zip(fwd_typed, typed))


def test_kernel_operands_copy_only_what_is_off():
    """One shifted input among aligned ones: only it is copied."""
    (q, k, v, g), (lse, delta) = _operands(torch.bfloat16, 128, 128, seed=2)
    k_off, delta_off = _shifted(k), _shifted(delta)
    (q2, k2, v2, g2), (lse2, delta2), _ = tfa.kernel_operands(
        128, (q, k_off, v, g), (lse, delta_off))
    assert q2 is q and v2 is v and g2 is g and lse2 is lse
    assert k2 is not k_off and k2.data_ptr() % 16 == 0 and torch.equal(k2, k)
    assert delta2 is not delta_off and delta2.data_ptr() % 16 == 0
    assert torch.equal(delta2, delta)
