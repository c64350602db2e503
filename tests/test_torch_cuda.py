"""The PyTorch port on the card: the CUDA flash-attention kernels against
their plain versions (at the reference's shapes too: head dims below 64,
seq lens off the 64-row tile), delivery into device memory with slab
recycling, a train step that goes through the kernels, vision batches on
the card equal to the CPU's with the pinned batch slot recycled only after
its copy, a ResNet step on the card against the CPU's, ViT steps: the
tiny one against the CPU's, ViT-B/16 at full width; and the train steps
captured as CUDA graphs against their eager bodies, bit for bit (new
shapes, the lr across replays, the scalar kernels' cluster launch under
capture, a capture that fails, a capture while another thread delivers);
the Parquet scan on the card against the CPU's (one host-to-device copy
a unit chunk, no host sync in its loop) and the OpGraph vision batches
on the card; an async delivery's
``block_until_ready`` tensor read on another stream, and a delivery under
the ``chaos:0`` fault plan equal to a clean one; at a world of 1 over NCCL,
a sharded delivery (a ``DTensor`` on the card) and the data-parallel
step captured with its all-reduces. Every test is marked ``cuda``
and skips without a CUDA device. This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py
"""


import collections
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from strom_torch.ckpt import (AsyncCheckpointer, restore_checkpoint,
                              save_checkpoint)
from strom_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
from strom_torch.config import StromConfig
from strom_torch.delivery.buffers import buf_addr
from strom_torch.delivery.core import StromContext
from strom_torch.formats.predecoded import LABELS_SUFFIX
from strom_torch.models.llama import LlamaConfig
from strom_torch.models.resnet import ResNet, ResNetConfig
from strom_torch.models.vit import ViT, ViTConfig
from strom_torch.ops import flash_attention as tfa
from strom_torch.parallel.train import (init_train_state, load_train_state,
                                        make_optimizer, make_resnet_sgd_step,
                                        make_train_step, make_vit_sgd_step,
                                        train_state_tree)
from strom_torch.pipelines import (make_predecoded_vision_pipeline,
                                   make_wds_vision_pipeline)

MiB = 1024 * 1024
pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,Dh", [(1, 256, 4, 2, 64),
                                         (2, 128, 4, 4, 128),
                                         (1, 192, 4, 2, 128),   # S % 128 == 64
                                         (1, 256, 12, 4, 64)])  # small's heads
def test_kernels_match_plain(cuda_device, dtype, causal, B, S, H, KV, Dh):
    _check_kernels_against_plain(cuda_device, dtype, causal, B, S, H, KV, Dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [63, 96, 192])
@pytest.mark.parametrize("Dh", [32, 48])
def test_kernels_take_the_reference_shapes(cuda_device, dtype, causal, S, Dh):
    """Head dims below 64 (zero-padded by the wrappers) and seq lens off the
    64-row tile (masked inside the kernels) against the plain versions at
    the same tolerances; the plain versions run with one block of S rows
    where 64 does not divide S, as the reference requires."""
    _check_kernels_against_plain(cuda_device, dtype, causal, 1, S, 4, 2, Dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [63, 192])
@pytest.mark.parametrize("Dh", [160, 256, 320])
def test_kernels_take_wide_heads(cuda_device, dtype, causal, S, Dh):
    """Heads wider than 128 (zero-padded to a multiple of 128) against the
    plain versions at the same tolerances: in bf16 at Dh 160 and 256 the
    three wgmma kernels, else the scalar kernels."""
    _check_kernels_against_plain(cuda_device, dtype, causal, 1, S, 4, 2, Dh)


def _check_kernels_against_plain(cuda_device, dtype, causal, B, S, H, KV, Dh):
    """Each CUDA kernel against its plain version on the same inputs.

    Against the plain version in f32: f32 kernels differ only in the order
    of f32 sums (1e-4). bf16 kernels round their outputs to bf16 (2^-9
    relative), so 1e-2 relative; they also round P and dS to bf16 where the
    JAX package does, and an element that cancels in a sum of such rounded
    terms can differ by a few 2^-9 of the largest value: 5e-3 of it. lse is
    f32 in both: 1e-3 absolute.
    bf16 kernels also against the plain version in bf16, which rounds at the
    same points: the f32 sums before the last rounding differ only in order,
    so an output may land one bf16 ulp away (8e-3 relative), plus 2e-3 of
    the largest value for elements that cancel; lse within 2e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, g = (torch.randn(*s, generator=gen, device=cuda_device).to(dtype)
                  for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh),
                            (B, S, H, Dh)))
    block = S if S % 64 else 64
    blk = dict(block_q=block, block_k=block)
    before = dict(tfa.LAUNCHES)
    out, lse = tfa._flash_fwd(q, k, v, causal=causal, **blk)
    delta = tfa._delta(out, g)
    grads = tfa._flash_bwd(q, k, v, out, lse, g, causal=causal, delta=delta,
                           **blk)
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        "fa_fwd": 1, "fa_bwd_dkv": 1, "fa_bwd_dq": 1}
    assert out.shape == q.shape and grads[0].shape == q.shape
    assert grads[1].shape == grads[2].shape == k.shape

    def check(ins, rtol, frac, lse_atol):
        pout, plse = tfa._flash_fwd_plain(*ins[:3], causal=causal, **blk)
        pgrads = tfa._flash_bwd_plain(*ins, lse, delta, causal=causal, **blk)
        torch.testing.assert_close(lse, plse, rtol=0, atol=lse_atol)
        for got, want in zip((out, *grads), (pout, *pgrads)):
            got, want = got.float(), want.float()
            torch.testing.assert_close(got, want, rtol=rtol,
                                       atol=frac * want.abs().max().item())

    f32 = [t.float() for t in (q, k, v, g)]
    if dtype == torch.float32:
        check(f32, 1e-4, 1e-5, 1e-3)
    else:
        check(f32, 1e-2, 5e-3, 1e-3)
        check([q, k, v, g], 8e-3, 2e-3, 2e-5)


@pytest.mark.parametrize("causal", [True, False])
# 192: a 128-row q tile half past S; 63: one tile, cut by S
@pytest.mark.parametrize("S, Dh", [(192, 64), (2048, 64), (192, 128),
                                   (2048, 128), (63, 256), (192, 256)])
def test_bf16_dq_rounds_ds_like_plain(cuda_device, causal, Dh, S):
    """The bf16 dQ kernel rounds dS to bf16 before dS·K, once, as the JAX
    package and the bf16 plain version do, at every width it has a layout
    for (64, 128, and 256 with no producer warpgroup and its K/V slot
    ring). Given the same lse and Δ, the two
    dq differ only where f32 sums in another order cross a bf16 rounding:
    within one bf16 ulp (8e-3 relative) plus 2e-3 of the largest value, and
    in under 5 % of the elements. A dS kept in f32 (the plain version fed k
    in f32) moves some 40 % of them, which shows the share can tell."""
    B, H, KV = 1, 4, 2
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, g = (torch.randn(*s, generator=gen, device=cuda_device)
                  .to(torch.bfloat16)
                  for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh),
                            (B, S, H, Dh)))
    out, lse = tfa._flash_fwd(q, k, v, causal=causal, block_q=64, block_k=64)
    delta = tfa._delta(out, g)
    before = tfa.LAUNCHES["fa_bwd_dq"]
    dq = tfa._bwd_dq_kernel(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["fa_bwd_dq"] == before + 1
    plain = tfa._flash_bwd_plain(q, k, v, g, lse, delta, causal=causal,
                                 block_q=64, block_k=64)[0]
    f32_ds = tfa._flash_bwd_plain(q, k.float(), v, g, lse, delta,
                                  causal=causal, block_q=64, block_k=64)[0]
    assert dq.dtype == plain.dtype == f32_ds.dtype == torch.bfloat16
    torch.testing.assert_close(dq.float(), plain.float(), rtol=8e-3,
                               atol=2e-3 * plain.float().abs().max().item())
    assert (dq != plain).float().mean().item() < 0.05
    assert (f32_ds != plain).float().mean().item() > 0.30


PROFILE_PAD_S = 0.1
PROFILE_TRIES = 3


def _device_names(call, kernel: str) -> tuple[str, int]:
    """The names of the events the profiler records for *call*, alone in a
    session, and the number of sessions (calls) that took.

    On the card's machine the profiler loses device events: the first
    ones of a session, more of them the older the process (after ~150 s
    every device event of a session of a few ms was gone), and now and
    then all of a session's, even with the call 100 ms inside the session
    (1 of 42 such sessions in one run). A pause before the call and after
    it keeps the call's events inside the session; a session that shows
    no event of *kernel* on either route (its name prefixes both
    ``<kernel>_kernel`` and ``<kernel>_wgmma_kernel``) says nothing of the
    route and is profiled again, up to PROFILE_TRIES sessions."""
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            call()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        names = " ".join(e.name for e in prof.events())
        if kernel in names:
            break
    return names, tries


def test_dq_kernel_by_dtype(cuda_device):
    """bf16 dq runs the tensor-core kernel, f32 dq the scalar one: the
    kernels' names as the profiler sees them on the device."""
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 128, 2, 64, device=cuda_device).to(dtype)
        k = torch.randn(1, 128, 1, 64, device=cuda_device).to(dtype)
        lse = torch.zeros(1, 2, 128, 1, device=cuda_device)
        names[dtype], _ = _device_names(
            lambda: tfa._bwd_dq_kernel(q, k, k, q, lse, lse, causal=True),
            "fa_bwd_dq")
    assert "fa_bwd_dq_wgmma_kernel" in names[torch.bfloat16]
    assert "fa_bwd_dq_kernel" in names[torch.float32]
    assert "fa_bwd_dq_wgmma_kernel" not in names[torch.float32]


@pytest.mark.parametrize("Dh", [256, 320])
def test_wide_kernels_by_name(cuda_device, Dh):
    """bf16 at Dh 256: all three run the wgmma kernels; at Dh 320 all
    three run the scalar kernels. The kernels' names as the profiler sees
    them on the device, and the one variant (kernel, library, dtype) each
    call counts a launch under."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q = torch.randn(1, 128, 2, Dh, generator=gen, device=cuda_device).bfloat16()
    k = torch.randn(1, 128, 1, Dh, generator=gen, device=cuda_device).bfloat16()
    lse = torch.zeros(1, 2, 128, 1, device=cuda_device)
    calls = {"fa_fwd": lambda: tfa._flash_fwd_kernel(q, k, k, causal=True),
             "fa_bwd_dkv": lambda: tfa._bwd_dkv_kernel(q, k, k, q, lse, lse,
                                                       causal=True),
             "fa_bwd_dq": lambda: tfa._bwd_dq_kernel(q, k, k, q, lse, lse,
                                                     causal=True)}
    for name, call in calls.items():
        before = collections.Counter(tfa.VARIANT_LAUNCHES)
        names, calls_made = _device_names(call, name)
        wgmma = Dh == 256
        assert (f"{name}_wgmma_kernel" in names) == wgmma, (name, names)
        assert (f"{name}_kernel" in names) == (not wgmma), (name, names)
        library = "sm90" if wgmma else "scalar"
        assert tfa.VARIANT_LAUNCHES - before == collections.Counter(
            {tfa.variant(name, library, torch.bfloat16): calls_made})


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [192, 2048])
def test_bf16_dkv_rounds_like_plain(cuda_device, causal, S):
    """The bf16 dK/dV kernel at Dh 256 (wgmma) rounds P to bf16 before dV
    and dS to bf16 before dK, once, as the JAX package and the bf16 plain
    version do. Given the same lse and Δ, the two differ only where f32 sums
    in another order cross a bf16 rounding: within one bf16 ulp (8e-3
    relative) plus 2e-3 of the largest value, and in under 5 % of the
    elements. P kept in f32 before dV (the plain version fed v in f32, its
    dv rounded to bf16 at the end) and dS kept in f32 before dK (fed q in
    f32) each move some 40 % of them, which shows the share can tell."""
    B, H, KV, Dh = 1, 4, 2, 256
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, g = (torch.randn(*s, generator=gen, device=cuda_device)
                  .to(torch.bfloat16)
                  for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh),
                            (B, S, H, Dh)))
    blk = dict(causal=causal, block_q=64, block_k=64)
    out, lse = tfa._flash_fwd(q, k, v, **blk)
    delta = tfa._delta(out, g)
    before = tfa.LAUNCHES["fa_bwd_dkv"]
    dk, dv = tfa._bwd_dkv_kernel(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["fa_bwd_dkv"] == before + 1
    _, pdk, pdv = tfa._flash_bwd_plain(q, k, v, g, lse, delta, **blk)
    f32_ds = tfa._flash_bwd_plain(q.float(), k, v, g, lse, delta, **blk)[1]
    f32_p = tfa._flash_bwd_plain(q, k, v.float(), g, lse, delta,
                                 **blk)[2].to(torch.bfloat16)
    for got, plain, f32 in ((dk, pdk, f32_ds), (dv, pdv, f32_p)):
        assert got.dtype == plain.dtype == f32.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), plain.float(), rtol=8e-3,
                                   atol=2e-3 * plain.float().abs().max().item())
        assert (got != plain).float().mean().item() < 0.05
        assert (f32 != plain).float().mean().item() > 0.30


@pytest.mark.parametrize("width", [192, 256, 384])
def test_sm90_dq_refuses_width_256(cuda_device, width):
    """The tensor-core dQ straight from its library at *width*: 256 has a
    layout (no producer warpgroup, a K/V slot ring), launches and counts
    one launch, and on zero inputs gives a zero dq; 192 and 384 have none,
    so the library refuses them, the launch raises and counts nothing. The
    route sends only 64, 128 and 256 there."""
    S, H, KV = 128, 2, 1
    q = torch.zeros(1, S, H, width, device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros(1, S, KV, width, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, H, S, device=cuda_device)
    dq = torch.full_like(q, float("nan"))
    before = tfa.LAUNCHES["fa_bwd_dq"]
    variants = collections.Counter(tfa.VARIANT_LAUNCHES)
    launch = lambda: tfa._launch(  # noqa: E731
        "fa_bwd_dq", "sm90", torch.bfloat16,
        tfa._sm90_lib().strom_fa_bwd_dq_sm90, width, q.data_ptr(),
        k.data_ptr(), k.data_ptr(), q.data_ptr(), lse.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), 1, S, S, H, KV, 1, 1.0 / 16,
        torch.cuda.current_stream().cuda_stream)
    if width == 256:
        launch()
        torch.cuda.synchronize()
        assert tfa.LAUNCHES["fa_bwd_dq"] == before + 1
        assert tfa.VARIANT_LAUNCHES - variants == collections.Counter(
            {"fa_bwd_dq@sm90/bf16": 1})
        assert (dq == 0).all()
    else:
        with pytest.raises(RuntimeError, match="unsupported"):
            launch()
        assert tfa.LAUNCHES["fa_bwd_dq"] == before
        assert collections.Counter(tfa.VARIANT_LAUNCHES) == variants
    assert tfa.kernel_route("fa_bwd_dq", torch.bfloat16, width) == (
        "sm90" if width == 256 else "scalar")


def _bwd_inputs(device, dtype, seed, B, S, H, KV, Dh, causal):
    """Seeded q, k, v, dO, the forward kernel's lse and Δ, and the plain
    versions' block (S where 64 does not divide S, as the reference
    requires)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn(*s, generator=gen, device=device).to(dtype)
                  for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh),
                            (B, S, H, Dh)))
    block = S if S % 64 else 64
    out, lse = tfa._flash_fwd(q, k, v, causal=causal, block_q=block,
                              block_k=block)
    return q, k, v, g, lse, tfa._delta(out, g), block


def _scalar_bwd(q, k, v, g, lse, delta, causal):
    """dq, dk, dv from the scalar kernels, each launched once (counted
    under its scalar variant)."""
    before = collections.Counter(tfa.VARIANT_LAUNCHES)
    dk, dv = tfa._bwd_dkv_kernel(q, k, v, g, lse, delta, causal=causal)
    dq = tfa._bwd_dq_kernel(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES - before == collections.Counter(
        {tfa.variant(n, "scalar", q.dtype): 1
         for n in ("fa_bwd_dkv", "fa_bwd_dq")})
    return dq, dk, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("S", [63, 192, 320])
def test_f32_backward_at_tile_edges(cuda_device, S, Dh, G, causal):
    """The f32 dK/dV and dQ kernels against the plain backward at the edges
    of their tiles: S 63 (one 64-row tile cut by S: rows past S staged as
    zeros, lse and Δ read as zeros past S), 192 and 320 (3 and 5 tiles, so
    the two-stage cp.async ring wraps), Dh 64 and 128 (one staged chunk)
    and 256 (two chunks restaged in turn), G 1 and 4 query heads a kv
    head (the loop a dK/dV CTA runs over them), causal and not. Given the
    same lse and Δ the two differ only in the order of f32 sums: 1e-4
    relative and 1e-5 of the largest value, as in
    _check_kernels_against_plain."""
    H, KV = (8, 2) if G == 4 else (2, 2)
    q, k, v, g, lse, delta, block = _bwd_inputs(cuda_device, torch.float32,
                                                6, 1, S, H, KV, Dh, causal)
    got = _scalar_bwd(q, k, v, g, lse, delta, causal)
    want = tfa._flash_bwd_plain(q, k, v, g, lse, delta, causal=causal,
                                block_q=block, block_k=block)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item(), msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [63, 192])
@pytest.mark.parametrize("Dh", [320, 512])
def test_bf16_scalar_backward_rounds_like_plain(cuda_device, Dh, S, causal):
    """bf16 heads above 256 run the scalar dK/dV and dQ (tiles converted to
    f32 when staged). They round P to bf16 before dV and dS before dK and
    dQ, once, as the JAX package and the bf16 plain version do: given the
    same lse and Δ, each output within one bf16 ulp (8e-3 relative) plus
    2e-3 of the largest value, and under 5 % of the elements different.
    P or dS kept in f32 (the plain version fed v, q or k in f32) moves
    over 30 % of them, which shows the share can tell."""
    q, k, v, g, lse, delta, block = _bwd_inputs(cuda_device, torch.bfloat16,
                                                7, 1, S, 8, 2, Dh, causal)
    got = _scalar_bwd(q, k, v, g, lse, delta, causal)
    blk = dict(causal=causal, block_q=block, block_k=block)
    plain = tfa._flash_bwd_plain(q, k, v, g, lse, delta, **blk)
    unrounded = (tfa._flash_bwd_plain(q, k.float(), v, g, lse, delta, **blk)[0],
                 tfa._flash_bwd_plain(q.float(), k, v, g, lse, delta,
                                      **blk)[1],
                 tfa._flash_bwd_plain(q, k, v.float(), g, lse, delta,
                                      **blk)[2].to(torch.bfloat16))
    for name, a, b, f32 in zip(("dq", "dk", "dv"), got, plain, unrounded):
        assert a.dtype == b.dtype == f32.dtype == torch.bfloat16, name
        torch.testing.assert_close(a.float(), b.float(), rtol=8e-3,
                                   atol=2e-3 * b.float().abs().max().item(),
                                   msg=name)
        assert (a != b).float().mean().item() < 0.05, name
        assert (f32 != b).float().mean().item() > 0.30, name


def test_scalar_backward_takes_unaligned_inputs(cuda_device):
    """The scalar backward stages its tiles with 16-byte cp.async copies.
    Contiguous inputs that start 4 bytes into their storage are copied to
    aligned memory first: dq, dk and dv equal those of aligned copies of
    the same inputs, bit for bit."""
    B, S, H, KV, Dh = 1, 128, 4, 2, 64
    aligned = _bwd_inputs(cuda_device, torch.float32, 8, B, S, H, KV, Dh,
                          True)[:6]

    def offset(t):
        flat = torch.empty(t.numel() + 1, device=cuda_device)[1:]
        return flat.view(t.shape).copy_(t)

    shifted = [offset(t) for t in aligned]
    assert all(t.data_ptr() % 16 == 4 and t.is_contiguous() for t in shifted)
    for a, b in zip(_scalar_bwd(*aligned, True), _scalar_bwd(*shifted, True)):
        assert torch.equal(a, b)


def _shifted(t):
    """A contiguous copy of *t* that starts 4 bytes into its storage."""
    skip = 4 // t.element_size()
    flat = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)[skip:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype,Dh", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                      (torch.bfloat16, 256), (torch.float32, 128)])
def test_kernels_take_unaligned_inputs(cuda_device, dtype, Dh):
    """Every flash kernel reads 16-byte-aligned memory: bf16 at 64, 128 and
    256 the sm90 kernels' TMA maps and bulk copies, f32 the scalar kernels'
    cp.async. Contiguous inputs that start 4 bytes into their storage (q,
    k, v, dO, and lse and Δ handed to _flash_bwd(delta=), the block-pair
    API; at S 128 no row padding copies them) are copied to aligned memory
    first: out, lse, dq, dk and dv equal those of aligned copies of the same
    inputs, bit for bit, launched from the route kernel_route names."""
    B, S, H, KV = 1, 128, 4, 2
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v, g = (torch.randn(*s, generator=gen, device=cuda_device).to(dtype)
                  for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh),
                            (B, S, H, Dh)))

    def run(q, k, v, g, lse=None, delta=None):
        out, flse = tfa._flash_fwd(q, k, v, causal=True)
        if lse is None:
            lse, delta = flse, tfa._delta(out, g)
        grads = tfa._flash_bwd(q, k, v, out, lse, g, causal=True, delta=delta)
        return (out, flse, *grads), lse, delta

    before = collections.Counter(tfa.VARIANT_LAUNCHES)
    want, lse, delta = run(q, k, v, g)
    shifted = [_shifted(t) for t in (q, k, v, g, lse, delta)]
    assert all(t.data_ptr() % 16 == 4 and t.is_contiguous() for t in shifted)
    got = run(*shifted)[0]
    torch.cuda.synchronize()
    library = tfa.kernel_route("fa_fwd", dtype, Dh)
    assert library == ("sm90" if dtype == torch.bfloat16 else "scalar")
    assert tfa.VARIANT_LAUNCHES - before == collections.Counter(
        {tfa.variant(n, library, dtype): 2 for n in tfa.LAUNCHES})
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), want, got):
        assert torch.equal(a, b), name


def _check_fwd_against_plain(out, lse, q, k, v, causal, block):
    """The forward kernel's out and lse against the plain forward on the
    same inputs, at the tolerances of _check_kernels_against_plain: f32
    1e-4 relative and 1e-5 of the largest value (f32 sums in another
    order), lse within 1e-3; bf16 against the plain version in f32 (1e-2,
    5e-3 of the largest value, lse 1e-3: the kernel rounds P and out to
    bf16) and in bf16 (one bf16 ulp, 8e-3 relative, plus 2e-3 of the
    largest value; lse within 2e-5)."""
    blk = dict(causal=causal, block_q=block, block_k=block)
    checks = [([t.float() for t in (q, k, v)], 1e-4, 1e-5, 1e-3)]
    if q.dtype == torch.bfloat16:
        checks = [([t.float() for t in (q, k, v)], 1e-2, 5e-3, 1e-3),
                  ([q, k, v], 8e-3, 2e-3, 2e-5)]
    for ins, rtol, frac, lse_atol in checks:
        pout, plse = tfa._flash_fwd_plain(*ins, **blk)
        assert out.shape == pout.shape and lse.shape == plse.shape
        torch.testing.assert_close(lse, plse, rtol=0, atol=lse_atol)
        torch.testing.assert_close(out.float(), pout.float(), rtol=rtol,
                                   atol=frac * pout.float().abs().max().item())


def _scalar_fwd(dtype, seed, S, H, KV, Dh, causal):
    """Seeded q, k, v and the scalar forward's (out, lse), launched once
    (counted under its scalar variant), and the plain versions' block."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(dtype)
               for s in ((1, S, H, Dh), (1, S, KV, Dh), (1, S, KV, Dh)))
    before = collections.Counter(tfa.VARIANT_LAUNCHES)
    out, lse = tfa._flash_fwd_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.VARIANT_LAUNCHES - before == collections.Counter(
        {tfa.variant("fa_fwd", "scalar", dtype): 1})
    return (q, k, v), out, lse, S if S % 64 else 64


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [63, 96, 192, 320])
@pytest.mark.parametrize("dtype,Dh", [(torch.float32, 64), (torch.float32, 128),
                                      (torch.float32, 384), (torch.float32, 512),
                                      (torch.bfloat16, 384), (torch.bfloat16, 512),
                                      (torch.bfloat16, 640)])
def test_scalar_forward_against_plain(cuda_device, dtype, Dh, S, G, causal):
    """The scalar forward (128-row q tiles over 64-row kv tiles in a
    two-stage ring; above 128 columns a cluster of one CTA a 128-column
    chunk summing its partial scores, 3, 4 and 5 CTAs here) against the
    plain forward, out and lse: S 63 (one tile cut by S), 96 (a q tile cut
    by S over two kv tiles), 192 and 320 (q tiles past S, and the ring
    wrapping), G 1 and 4 query heads a kv head, causal and not."""
    H, KV = (8, 2) if G == 4 else (2, 2)
    ins, out, lse, block = _scalar_fwd(dtype, 11, S, H, KV, Dh, causal)
    _check_fwd_against_plain(out, lse, *ins, causal, block)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [63, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_forward_beyond_one_cluster(cuda_device, dtype, S, causal):
    """A head of 1152 columns is 9 chunks, more than a portable cluster of
    8 CTAs holds: each q tile runs two clusters of 8, CTA r summing the
    partial scores of chunks r and r + 8 (restaged chunk by chunk, no
    ring), and only chunk 8's CTA of the second cluster writes output. The
    same tolerances against the plain forward."""
    ins, out, lse, block = _scalar_fwd(dtype, 12, S, 4, 2, 1152, causal)
    _check_fwd_against_plain(out, lse, *ins, causal, block)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [63, 192])
def test_bf16_scalar_forward_rounds_like_plain(cuda_device, S, causal):
    """bf16 at Dh 512 runs the scalar forward (a cluster of 4 CTAs). It
    rounds P to bf16 before P·V, as the JAX package and the bf16 plain
    version do (strom/ops/flash_attention.py:79), and sums the row's
    denominator from the unrounded P: out within one bf16 ulp (8e-3
    relative) plus 2e-3 of the largest value, and under 5 % of its
    elements different. P kept in f32 (the plain version fed v in f32)
    moves 33-38 % of them at these shapes (the plain versions on the CPU),
    so over 25 % shows the share can tell the two apart."""
    (q, k, v), out, lse, block = _scalar_fwd(torch.bfloat16, 13, S, 8, 2, 512,
                                             causal)
    blk = dict(causal=causal, block_q=block, block_k=block)
    plain, _ = tfa._flash_fwd_plain(q, k, v, **blk)
    unrounded, _ = tfa._flash_fwd_plain(q, k, v.float(), **blk)
    assert out.dtype == plain.dtype == unrounded.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), plain.float(), rtol=8e-3,
                               atol=2e-3 * plain.float().abs().max().item())
    assert (out != plain).float().mean().item() < 0.05
    assert (unrounded != plain).float().mean().item() > 0.25


def test_kernel_wrapper_raises_on_unsupported_cuda_input(cuda_device):
    """A CUDA tensor the kernel does not take raises; nothing falls back to
    the plain version. Every head dim and any seq len are taken: a head of
    256 launches the scalar kernel."""
    q = torch.zeros(1, 64, 2, 256, device=cuda_device)
    before = tfa.LAUNCHES["fa_fwd"]
    out = tfa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert out.shape == q.shape and tfa.LAUNCHES["fa_fwd"] == before + 1
    q = torch.zeros(1, 128, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 2, 128, device=cuda_device).transpose(1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q, q, q)
    # the dQ wrapper itself, bf16 (the tensor-core kernel's dtype)
    lse = torch.zeros(1, 2, 128, 1, device=cuda_device)
    q = torch.zeros(1, 96, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[B,H,S,1\]"):
        tfa._bwd_dq_kernel(q, q, q, q, lse, lse, causal=True)
    q = torch.zeros(1, 128, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        tfa._bwd_dq_kernel(q, q, q, q, lse.bfloat16(), lse, causal=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._bwd_dq_kernel(q, q, q, q, lse.cpu(), lse, causal=True)


def _streamed(ctx) -> int:
    """The process-wide streamed-delivery count, as ctx.stats() reads it."""
    return ctx.stats(["context"])["context"]["streamed_transfers"]


def test_streamed_delivery_recycles_slabs(cuda_device, tmp_path):
    """Two back-to-back streamed transfers: the second reuses the first's
    pinned slabs (pool hits), and both land byte-exact on the card."""
    data = np.random.default_rng(0).integers(0, 256, 6 * MiB + 4096,
                                             dtype=np.uint8)
    path = str(tmp_path / "f.bin")
    data.tofile(path)
    want = torch.from_numpy(data[: 6 * MiB]).to(cuda_device)
    ctx = StromContext(StromConfig(queue_depth=8, num_buffers=8,
                                   overlap_chunk_bytes=MiB,
                                   overlap_min_bytes=2 * MiB))
    try:
        streamed0 = _streamed(ctx)
        a = ctx.memcpy_ssd2gpu(path, length=6 * MiB, device=cuda_device)
        b = ctx.memcpy_ssd2gpu(
            path, length=6 * MiB, device=cuda_device, async_=True).result(60)
        torch.cuda.synchronize()
        assert torch.equal(a, want) and torch.equal(b, want)
        st = ctx.stats()
        assert _streamed(ctx) - streamed0 == 2
        assert st["slab_pool"]["hits"] > 0 and st["slab_pool"]["pinned_bytes"] > 0
        small = ctx.memcpy_ssd2gpu(path, offset=4096, shape=(256, 256),
                                   dtype=np.int32, device=cuda_device)
        torch.cuda.synchronize()
        assert torch.equal(small.cpu(), torch.from_numpy(
            data[4096: 4096 + 256 * 256 * 4].view(np.int32).reshape(256, 256)))
    finally:
        ctx.close()


def test_cache_served_delivery_recycles_slabs(cuda_device, tmp_path):
    """With the hot cache on, a repeat streamed transfer is served from
    RAM into the pool's pinned slabs, which recycle only after their copies
    retired: byte-exact on the card, the cache's hits counted, pool hits."""
    data = np.random.default_rng(2).integers(0, 256, 6 * MiB, dtype=np.uint8)
    path = str(tmp_path / "c.bin")
    data.tofile(path)
    want = torch.from_numpy(data).to(cuda_device)
    ctx = StromContext(StromConfig(queue_depth=8, num_buffers=8,
                                   overlap_chunk_bytes=MiB,
                                   overlap_min_bytes=2 * MiB,
                                   hot_cache_bytes=16 * MiB,
                                   hot_cache_admit="always"))
    try:
        outs = [ctx.memcpy_ssd2gpu(path, device=cuda_device)
                for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)
        st = ctx.stats()
        assert st["cache"]["cache_hit_bytes"] == 2 * 6 * MiB
        assert st["slab_pool"]["hits"] > 0
    finally:
        ctx.close()


@pytest.mark.parametrize("route", ["put_host_batch", "streamed"])
def test_delivered_tensor_never_takes_a_block_in_queued_use(cuda_device,
                                                            tmp_path, route):
    """A block freed while work that writes it is still queued on the
    consumer stream must not become the delivered tensor: the copy stream
    is not ordered after that work, so the queued fill would land on top of
    the delivered bytes."""
    n = 4 * MiB
    data = np.random.default_rng(3).integers(0, 256, n, dtype=np.uint8)
    path = str(tmp_path / "q.bin")
    data.tofile(path)
    want = torch.from_numpy(data).to(cuda_device)
    ctx = StromContext(StromConfig(queue_depth=8, num_buffers=8,
                                   overlap_chunk_bytes=MiB,
                                   overlap_min_bytes=2 * MiB))

    def staged():
        """A delivery ready to launch. Pinning a host slab may wait for
        the card, so a host batch is filled here, not in the launch."""
        if route == "put_host_batch":
            host = ctx.host_batch((n,), cuda_device)
            host[:] = data
            return lambda: ctx.put_host_batch(host, cuda_device)
        return lambda: ctx.memcpy_ssd2gpu(path, length=n, device=cuda_device)

    try:
        streamed0 = _streamed(ctx)
        # what may wait for the card happens before the queued work: the
        # first delivery sets up the copy stream, and the first launch of
        # a kernel loads its module. The first delivery stays alive, so
        # the only free block of its size is the one freed below
        first = staged()()
        deliver = staged()
        torch.cuda._sleep(1)
        torch.empty(1, dtype=torch.uint8, device=cuda_device).fill_(7)
        torch.cuda.synchronize()
        busy = torch.empty(n, dtype=torch.uint8, device=cuda_device)
        torch.cuda._sleep(1 << 30)   # about half a second of queued work
        busy.fill_(7)
        del busy                     # its block is free, its fill queued
        out = deliver()
        torch.cuda.synchronize()
        assert torch.equal(first, want) and torch.equal(out, want)
        if route == "streamed":
            assert _streamed(ctx) - streamed0 == 2
    finally:
        ctx.close()


def test_ring_registered_slabs_recycle_byte_exact(cuda_device, tmp_path):
    """Pool slabs pinned by CUDA and registered with the io_uring ring as
    well: two back-to-back streamed transfers of a cold file, the second
    recycling the first's slabs, both byte-exact on the card; the gathers
    land in registered slabs (READ_FIXED where the file takes O_DIRECT)."""
    import os

    from strom_torch.engine import uring_engine

    if not uring_engine.uring_available():
        pytest.skip(f"io_uring unavailable: {uring_engine.unavailable_reason}")
    data = np.random.default_rng(1).integers(0, 256, 6 * MiB, dtype=np.uint8)
    path = str(tmp_path / "cold.bin")
    with open(path, "wb") as f:
        data.tofile(f)
        f.flush()
        os.fsync(f.fileno())
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
    want = torch.from_numpy(data).to(cuda_device)
    ctx = StromContext(StromConfig(engine="uring", queue_depth=8, num_buffers=8,
                                   overlap_chunk_bytes=MiB,
                                   overlap_min_bytes=2 * MiB))
    try:
        streamed0 = _streamed(ctx)
        a = ctx.memcpy_ssd2gpu(path, device=cuda_device)
        b = ctx.memcpy_ssd2gpu(path, device=cuda_device, async_=True).result(60)
        torch.cuda.synchronize()
        assert torch.equal(a, want) and torch.equal(b, want)
        st = ctx.stats()
        assert _streamed(ctx) - streamed0 == 2 and st["slab_pool"]["hits"] > 0
        eng = st["engine"]
        assert eng["engine"] == "uring" and eng["dest_refused"] == 0
        assert eng["ext_buffers"] == st["slab_pool"]["misses"] > 0
        if ctx.uses_o_direct(path):
            assert eng["ops_fixed"] > 0
    finally:
        ctx.close()


@pytest.mark.parametrize("S", [128, 63])
def test_train_step_goes_through_the_kernels(cuda_device, S):
    """LlamaConfig.tiny() as it is (head dim 32, zero-padded to the kernels'
    64), at a seq len on the kernels' tile and at 63, off it."""
    cfg = LlamaConfig.tiny()
    state = init_train_state(cfg, device=cuda_device, seed=0)
    step = make_train_step(cfg, attn="flash", device=cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, S), dtype=np.int32)).to(cuda_device)
    tfa.reset_launch_counts()
    losses = []
    for _ in range(2):
        state, m = step(state, tokens)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses))
    # forward + remat recompute per layer and step; one of each backward
    assert dict(tfa.LAUNCHES) == {"fa_fwd": 8, "fa_bwd_dkv": 4, "fa_bwd_dq": 4}


def _raw_tar(path: str, n: int = 12, side: int = 8) -> None:
    """A WebDataset tar whose "jpg" members are raw side×side×3 pixels."""
    import io
    import tarfile

    rng = np.random.default_rng(4)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            px = rng.integers(0, 256, side * side * 3, dtype=np.uint8).tobytes()
            for name, data in ((f"s{i:04d}.jpg", px),
                               (f"s{i:04d}.cls", str(i).encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def _raw_transform(side: int):
    """A decoder-free transform with out=: the member's pixels xor one
    random byte, so the slot path runs on a host without cv2 or PIL."""
    def tf(data, rng, out=None):
        img = np.frombuffer(bytes(data), np.uint8).reshape(side, side, 3) \
            ^ np.uint8(rng.integers(0, 256))
        if out is None:
            return img.copy()
        out[...] = img
        return out

    return tf


@pytest.mark.parametrize("stream", [True, False])
def test_vision_slot_batches_on_cuda(cuda_device, tmp_path, monkeypatch,
                                     stream):
    """make_wds_vision_pipeline on the card: batches equal the CPU's, and a
    pinned batch slot goes back to the pool only once the copy that reads
    it has retired (its event has completed), streamed or not."""
    path = str(tmp_path / "raw.tar")
    _raw_tar(path)
    ctx = StromContext(StromConfig(queue_depth=8, num_buffers=8))
    copies: dict[int, torch.cuda.Event] = {}
    recycled: list[bool] = []
    real_copy, real_release = ctx._copy_async, ctx._slab_pool.release

    def copy_async(dst, slab, stream_):
        ev = real_copy(dst, slab, stream_)
        copies[buf_addr(slab)] = ev
        return ev

    def release(arr):
        recycled.append(copies[buf_addr(arr)].query())
        real_release(arr)

    monkeypatch.setattr(ctx, "_copy_async", copy_async)
    monkeypatch.setattr(ctx._slab_pool, "release", release)

    def batches(device):
        with make_wds_vision_pipeline(ctx, [path], batch=4, image_size=8,
                                      device=device, seed=2,
                                      transform=_raw_transform(8),
                                      decode_workers=2,
                                      stream_intra_batch=stream) as pipe:
            out = [next(pipe) for _ in range(5)]
            torch.cuda.synchronize()
            return out, pipe.stats()

    try:
        on_card, stats = batches(cuda_device)
        on_cpu, _ = batches("cpu")
        for (ci, cl), (hi, hl) in zip(on_card, on_cpu):
            assert ci.is_cuda and cl.is_cuda and cl.dtype == torch.int32
            assert torch.equal(ci.cpu(), hi) and torch.equal(cl.cpu(), hl)
        assert recycled and all(recycled)
        assert ctx._slab_pool.stats()["hits"] > 0
        assert ("stream_batches" in stats) == stream
    finally:
        ctx.close()


def test_predecoded_batches_on_cuda_equal_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(8)
    path = str(tmp_path / "p.pdec")
    records = rng.integers(0, 256, (20, 16, 16, 3), dtype=np.uint8)
    records.tofile(path)
    np.save(path + LABELS_SUFFIX, rng.integers(0, 1000, 20, dtype=np.int32))
    ctx = StromContext(StromConfig())
    try:
        out = {}
        for dev in (cuda_device, torch.device("cpu")):
            with make_predecoded_vision_pipeline(ctx, [path], batch=8,
                                                 image_size=16, device=dev,
                                                 seed=4) as pipe:
                out[dev.type] = [tuple(t.cpu() for t in next(pipe))
                                 for _ in range(4)]
        for (a, la), (b, lb) in zip(out["cuda"], out["cpu"]):
            assert torch.equal(a, b) and torch.equal(la, lb)
    finally:
        ctx.close()


def test_resnet_step_on_cuda_matches_cpu(cuda_device):
    """Two SGD steps of the tiny ResNet in f32, TF32 off: cuDNN's
    channels_last convolutions against the CPU's, same weights and
    batches. f32 sums in another order: 1e-4 of the largest value."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ResNetConfig.tiny(), dtype="float32")
    models = {d: ResNet(cfg, device=d) for d in ("cpu", cuda_device)}
    models[cuda_device].load_state_dict(models["cpu"].state_dict())
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), np.uint8))
    labels = torch.from_numpy(rng.integers(0, 1000, 8, dtype=np.int32))
    for d, model in models.items():
        step = make_resnet_sgd_step(cfg, device=d)
        for _ in range(2):
            m = step(model, images, labels)
        assert np.isfinite(m["loss"].item())
    want = models["cpu"].state_dict()
    for k, v in models[cuda_device].state_dict().items():
        torch.testing.assert_close(v.cpu(), want[k], rtol=0,
                                   atol=1e-4 * want[k].abs().max().item() + 1e-7)


def test_vit_step_on_cuda_matches_cpu(cuda_device):
    """Two SGD steps of the tiny ViT in f32, TF32 off, on the card and on
    the CPU from the same weights and batches: f32 sums in another order,
    1e-4 of each tensor's largest value."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ViTConfig.tiny(), dtype="float32")
    models = {d: ViT(cfg, device=d) for d in ("cpu", cuda_device)}
    models[cuda_device].load_state_dict(models["cpu"].state_dict())
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), np.uint8))
    labels = torch.from_numpy(rng.integers(0, 1000, 8, dtype=np.int32))
    for d, model in models.items():
        step = make_vit_sgd_step(cfg, device=d)
        for _ in range(2):
            assert np.isfinite(step(model, images, labels)["loss"].item())
    want = models["cpu"].state_dict()
    for k, v in models[cuda_device].state_dict().items():
        torch.testing.assert_close(v.cpu(), want[k], rtol=0,
                                   atol=1e-4 * want[k].abs().max().item() + 1e-7)


def test_vit_b16_step_on_cuda(cuda_device):
    """ViT-B/16 at full width in bf16, batch 16: two steps with a finite
    loss and grad norm; the bf16 weights stay bf16 and move."""
    cfg = ViTConfig.vit_b16()
    model = ViT(cfg, device=cuda_device,
                generator=torch.Generator(device=cuda_device).manual_seed(0))
    before = model.layers[0].wqkv.detach().clone()
    step = make_vit_sgd_step(cfg, device=cuda_device)
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.integers(0, 256, (16, 224, 224, 3),
                                           np.uint8)).to(cuda_device)
    labels = torch.from_numpy(rng.integers(0, 1000, 16, dtype=np.int32))
    for _ in range(2):
        m = step(model, images, labels.to(cuda_device))
        assert np.isfinite(m["loss"].item()) and np.isfinite(
            m["grad_norm"].item())
    assert model.layers[0].wqkv.dtype == torch.bfloat16
    assert not torch.equal(model.layers[0].wqkv, before)


# ------------------------------------------------------- captured steps
def _llama_runs(device, cfg, batches, attn="flash", warmup=100):
    """The same batches through the captured step and through its eager
    body, each on a fresh state from seed 0: per step the loss and grad
    norm, and the parameters at the end."""
    out = {}
    for captured in (True, False):
        spec = make_optimizer(warmup=warmup)
        state = init_train_state(cfg, spec, device=device, seed=0)
        step = make_train_step(cfg, spec, attn=attn, device=device)
        fn = step if captured else step.eager
        metrics = []
        for tokens in batches:
            state, m = fn(state, tokens)
            metrics.append((m["loss"], m["grad_norm"]))
        out[captured] = (metrics, {k: v.clone() for k, v in
                                   state.model.state_dict().items()}, step)
    return out


def _token_batches(device, cfg, shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, cfg.vocab, s, dtype=np.int32)
                             ).to(device) for s in shapes]


def _assert_bit_equal(runs):
    (got, gp, _), (want, wp, _) = runs[True], runs[False]
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (i, a, b)
    for k in gp:
        assert torch.equal(gp[k], wp[k]), k


@pytest.mark.parametrize("n_heads", [2, 4])   # Dh 64, and tiny's 32 (padded)
def test_captured_llama_steps_equal_uncaptured(cuda_device, n_heads):
    """Five flash steps as a graph (warm-up, capture, three replays) and
    five of the eager body: the same kernels in the same order, so the
    losses, grad norms and parameters are bit-equal."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), n_heads=n_heads,
                              n_kv_heads=n_heads // 2)
    runs = _llama_runs(cuda_device, cfg,
                       _token_batches(cuda_device, cfg, [(2, 128)] * 5))
    _assert_bit_equal(runs)
    step = runs[True][2]
    assert step.graphs == 1 and step.last_call == "replay"


def _scrape_loop(port: int, routes, stop: threading.Event,
                 out: "collections.Counter") -> None:
    """GET each route in turn until *stop*; counts status codes."""
    import urllib.error
    import urllib.request

    while not stop.is_set():
        for r in routes:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{r}",
                                            timeout=10) as resp:
                    resp.read()
                    out[resp.status] += 1
            except urllib.error.HTTPError as e:
                out[e.code] += 1


@pytest.mark.parametrize("routes", [
    ("/metrics?sections=context,sched",),
    ("/metrics", "/stats", "/trace", "/slo", "/history", "/tenants",
     "/flight")])
def test_scrapes_during_a_capture_leave_it_intact(cuda_device, routes):
    """A scraper thread hammers the live endpoint (the history sampler
    running too) while a flash step warms up, is captured and replays: no
    reader makes a device call that joins or breaks the capture, so the
    captured steps stay bit-equal to the eager body, and every scrape
    answers 200."""
    cfg = LlamaConfig.tiny()
    ctx = StromContext(StromConfig(history_interval_s=0.01), metrics_port=0)
    codes: collections.Counter = collections.Counter()
    stop = threading.Event()
    t = threading.Thread(target=_scrape_loop, args=(
        ctx.metrics_server.port, routes, stop, codes))
    try:
        t.start()
        runs = _llama_runs(cuda_device, cfg,
                           _token_batches(cuda_device, cfg, [(2, 128)] * 5))
    finally:
        stop.set()
        t.join()
        ctx.close()
    _assert_bit_equal(runs)
    assert runs[True][2].graphs == 1
    assert codes[200] > 0 and set(codes) == {200}, codes


def test_captured_lr_moves_across_replays(cuda_device):
    """warmup=2: the first step runs at lr 0 and leaves the weights as they
    were; the third, a replay at the schedule's peak, moves them, as the
    eager body does, bit for bit."""
    cfg = LlamaConfig.tiny()
    spec = make_optimizer(warmup=2)
    state = init_train_state(cfg, spec, device=cuda_device, seed=0)
    step = make_train_step(cfg, spec, attn="flash", device=cuda_device)
    lr = state.optimizer.param_groups[0]["lr"]
    weights = [state.model.wq.detach().clone()]
    lrs = []
    for tokens in _token_batches(cuda_device, cfg, [(2, 64)] * 3):
        lrs.append(lr.item())
        state, _ = step(state, tokens)
        weights.append(state.model.wq.detach().clone())
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert step.last_call == "replay"
    assert lrs == pytest.approx([0.0, 1.5e-4, 3e-4], rel=1e-6)
    assert torch.equal(weights[1], weights[0])
    assert not torch.equal(weights[3], weights[2])
    runs = _llama_runs(cuda_device, cfg,
                       _token_batches(cuda_device, cfg, [(2, 64)] * 3),
                       warmup=2)
    _assert_bit_equal(runs)


def test_captured_step_refills_its_input(cuda_device):
    """Two replays on different batches give different losses, each the
    eager body's on its batch: the static input buffer is refilled."""
    cfg = LlamaConfig.tiny()
    batches = _token_batches(cuda_device, cfg, [(2, 64)] * 2)
    batches += [batches[0].flip(1), batches[1].flip(1)]
    runs = _llama_runs(cuda_device, cfg, batches)
    _assert_bit_equal(runs)
    losses = [m[0].item() for m in runs[True][0]]
    assert losses[2] != losses[3]


def test_second_shape_captures_second_graph(cuda_device):
    """A new input shape warms up and captures a graph of its own, as jit
    retraces; the first graph, replayed after it, still gives the eager
    body's results."""
    cfg = LlamaConfig.tiny()
    shapes = [(2, 64)] * 3 + [(2, 128)] * 3 + [(2, 64)] * 2
    runs = _llama_runs(cuda_device, cfg,
                       _token_batches(cuda_device, cfg, shapes))
    _assert_bit_equal(runs)
    assert runs[True][2].graphs == 2


def test_captured_f32_flash_step_runs_the_scalar_kernels(cuda_device):
    """f32 at a head of 160 (padded to 256): the scalar kernels, the
    forward a cluster of two CTAs launched with cudaLaunchKernelEx, under
    the graph; bit-equal to the eager body, and the replays counted."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), d_model=320, n_heads=2,
                              n_kv_heads=1, dtype="float32")
    tfa.reset_launch_counts()
    runs = _llama_runs(cuda_device, cfg,
                       _token_batches(cuda_device, cfg, [(2, 128)] * 4))
    _assert_bit_equal(runs)
    # 4 captured and 4 eager steps, 2 layers: fwd + recompute, dkv, dq
    assert dict(tfa.VARIANT_LAUNCHES) == {
        "fa_fwd@scalar/f32": 32, "fa_bwd_dkv@scalar/f32": 16,
        "fa_bwd_dq@scalar/f32": 16}


def test_captured_vision_steps_equal_uncaptured(cuda_device):
    """The tiny ResNet (bf16) and a tiny ViT at S 197 (bf16; keys padded
    to 200): three captured steps against three of the eager body on
    fresh models, bit-equal."""
    rng = np.random.default_rng(3)
    vit_cfg = dataclasses.replace(ViTConfig.tiny(), image_size=112)
    for cfg, make_model, make_step, side in (
            (ResNetConfig.tiny(), ResNet, make_resnet_sgd_step, 32),
            (vit_cfg, ViT, make_vit_sgd_step, 112)):
        batches = [(torch.from_numpy(rng.integers(0, 256, (4, side, side, 3),
                                                  np.uint8)).to(cuda_device),
                    torch.from_numpy(rng.integers(0, 1000, 4, dtype=np.int32)
                                     ).to(cuda_device)) for _ in range(3)]
        out = {}
        for captured in (True, False):
            model = make_model(cfg, device=cuda_device,
                               generator=torch.Generator(
                                   device=cuda_device).manual_seed(0))
            step = make_step(cfg, device=cuda_device)
            fn = step if captured else step.eager
            losses = [fn(model, *b)["loss"] for b in batches]
            out[captured] = losses, {k: v.clone() for k, v in
                                     model.state_dict().items()}
        assert step.last_call == "eager"
        (gl, gp), (wl, wp) = out[True], out[False]
        assert all(torch.equal(a, b) for a, b in zip(gl, wl)), (cfg, gl, wl)
        for k in gp:
            assert torch.equal(gp[k], wp[k]), (cfg, k)


def test_failed_capture_raises_and_runs_nothing_eagerly(cuda_device):
    """A body that syncs with the host cannot be captured: the call that
    captures raises, and nothing ran the body eagerly in its place (the
    owner's counter moved once, in the warm-up)."""
    from strom_torch.parallel.capture import CapturedStep

    def body(owner, x):
        owner.add_(x)
        if owner.sum().item() < 0:   # a host read: refused under capture
            owner.zero_()
        return {"loss": owner.sum()}

    owner = torch.zeros(3, device=cuda_device)
    step = CapturedStep(body, cuda_device)
    one = torch.ones(3, device=cuda_device)
    assert step(owner, one)["loss"].item() == 3.0
    assert step.last_call == "warmup"
    with pytest.raises(RuntimeError):
        step(owner, one)
    torch.cuda.synchronize()
    assert owner.tolist() == [1.0, 1.0, 1.0]
    assert step.graphs == 0
    assert torch.cuda.current_stream() == torch.cuda.default_stream()


# ------------------------------------------------------------ parquet scan
def _pq_fixture(tmp_path, n=50_000, groups=5):
    """Two PLAIN shards from the port's writer: value float32, wide
    float64, seq int64 (a global arange), 2-page row groups."""
    from strom_torch.formats.parquet import write_parquet

    rng = np.random.default_rng(12)
    cols = {"value": rng.standard_normal(2 * n).astype(np.float32),
            "wide": rng.standard_normal(2 * n),
            "seq": np.arange(2 * n, dtype=np.int64)}
    paths = []
    with StromContext(StromConfig()) as ctx:
        for s in range(2):
            p = str(tmp_path / f"s{s}.parquet")
            write_parquet(ctx, p, {k: v[s * n: (s + 1) * n]
                                   for k, v in cols.items()},
                          row_group_rows=n // groups)
            paths.append(p)
    return paths, cols


def _pq_map(expect_cuda: bool):
    def map_fn(c):
        for name, dtype in (("value", torch.float32), ("wide", torch.float64),
                            ("seq", torch.int64)):
            assert c[name].is_cuda == expect_cuda and c[name].dtype == dtype
        return {"hits": (c["value"] > 0).sum(), "fsum": c["value"].sum(),
                "wsum": c["wide"].sum(), "ssum": [c["seq"].sum()]}

    return map_fn


def test_parquet_scan_on_cuda_equals_cpu(cuda_device, tmp_path):
    """The same scan on the card and on the CPU, with and without a
    predicate: counts and int64 sums exact, float64 sums at rtol 1e-12,
    float32 sums at rtol 1e-5 and atol 1e-3 (float32 summed in another
    order over 20,000-row units: the sum of 100,000 standard normals may
    lie near 0, so an absolute floor beside the relative one); map_fn sees
    CUDA tensors in each column's dtype."""
    from strom_torch.ops.pushdown import col
    from strom_torch.pipelines import parquet_scan_aggregate

    paths, cols = _pq_fixture(tmp_path)
    ctx = StromContext(StromConfig())
    try:
        decoded0 = ctx.scope.counter("parquet_decode_bytes").value
        for pred in (None, col("seq") < 37_000):
            out = {dev: parquet_scan_aggregate(
                       ctx, paths, ["value", "wide", "seq"],
                       _pq_map(dev == "cuda"), predicate=pred,
                       unit_batch=2, devices=[dev])
                   for dev in ("cuda", "cpu")}
            assert out["cuda"]["hits"] == out["cpu"]["hits"]
            assert out["cuda"]["ssum"] == out["cpu"]["ssum"]
            np.testing.assert_allclose(out["cuda"]["wsum"], out["cpu"]["wsum"],
                                       rtol=1e-12)
            np.testing.assert_allclose(out["cuda"]["fsum"], out["cpu"]["fsum"],
                                       rtol=1e-5, atol=1e-3)
            keep = slice(None) if pred is None else slice(0, 37_000)
            assert out["cuda"]["hits"] == int((cols["value"][keep] > 0).sum())
        assert ctx.scope.counter("parquet_decode_bytes").value == decoded0
    finally:
        ctx.close()


def test_parquet_scan_one_copy_a_unit_and_no_sync(cuda_device, tmp_path,
                                                  monkeypatch):
    """unit_batch 3 over 10 row groups: one put_host_batch (one
    host-to-device copy) for each of the 4 unit chunks; the scan's loop and
    its prefetch threads run under sync debug mode "error" (no host sync per
    unit), and only the final copy to the host runs outside it."""
    from strom_torch.pipelines import parquet_scan as ps

    paths, cols = _pq_fixture(tmp_path)
    ctx = StromContext(StromConfig())
    puts: list[int] = []
    real_put, real_to_host = ctx.put_host_batch, ps._to_host

    def put(host, device):
        puts.append(host.nbytes)
        return real_put(host, device)

    def to_host(tree):
        torch.cuda.set_sync_debug_mode(0)
        return real_to_host(tree)

    monkeypatch.setattr(ctx, "put_host_batch", put)
    monkeypatch.setattr(ps, "_to_host", to_host)
    try:
        # warm the slab pool (its first slabs are pinned, a registration)
        ps.parquet_scan_aggregate(ctx, paths, ["value", "wide", "seq"],
                                  _pq_map(True), unit_batch=3)
        puts.clear()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = ps.parquet_scan_aggregate(
                ctx, paths, ["value", "wide", "seq"], _pq_map(True),
                unit_batch=3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert len(puts) == 4
        assert out["hits"] == int((cols["value"] > 0).sum())
        assert out["ssum"][0] == cols["seq"].sum()
    finally:
        ctx.close()


def test_opgraph_batches_on_cuda_equal_cpu(cuda_device, tmp_path):
    """The wds pipeline with an OpGraph (project, normalize, cast) delivers
    float32 batches of the graph's shape on the card, equal to the CPU's,
    fused and not."""
    from strom_torch.ops.pushdown import OpGraph

    path = str(tmp_path / "raw.tar")
    _raw_tar(path)
    ctx = StromContext(StromConfig(queue_depth=8, num_buffers=8))

    def batches(device, fuse):
        graph = (OpGraph().project(slice(0, 6), slice(1, 7))
                 .normalize([127.5] * 3, [63.0] * 3).cast(np.float32))
        with make_wds_vision_pipeline(ctx, [path], batch=4, image_size=8,
                                      device=device, seed=2,
                                      transform=_raw_transform(8),
                                      decode_workers=2, opgraph=graph,
                                      opgraph_fuse=fuse) as pipe:
            out = [tuple(t.cpu() for t in next(pipe)) for _ in range(4)]
            torch.cuda.synchronize()
            return out

    try:
        want = batches("cpu", False)
        for fuse in (True, False):
            got = batches(cuda_device, fuse)
            for (gi, gl), (wi, wl) in zip(got, want):
                assert gi.shape == (4, 6, 6, 3) and gi.dtype == torch.float32
                assert torch.equal(gi, wi) and torch.equal(gl, wl)
    finally:
        ctx.close()


# ------------------------------------------------------------ checkpoints
def _ckpt_ctx():
    return StromContext(StromConfig(queue_depth=8, num_buffers=8,
                                    slab_pool_bytes=64 * MiB))


@pytest.mark.parametrize("verify", [False, True])
def test_cuda_state_saved_and_restored_on_the_card(cuda_device, tmp_path,
                                                   verify):
    """Card leaves (bf16, f32, a 0-d step, a non-contiguous view) saved
    through the engine and restored onto the card, bit-equal."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    tree = {"w": torch.randn(513, 257, device=cuda_device, generator=g
                             ).to(torch.bfloat16),
            "m": [torch.randn(3 * MiB, device=cuda_device, generator=g),
                  torch.zeros((), device=cuda_device)],
            "t": torch.randn(64, 96, device=cuda_device, generator=g).t(),
            "step": 5}
    with _ckpt_ctx() as ctx:
        w0 = ctx.stats()["context"]["host2ssd_bytes"]
        m = save_checkpoint(ctx, str(tmp_path / "c"), tree)
        got = restore_checkpoint(ctx, str(tmp_path / "c"), tree,
                                 verify=verify)
        assert ctx.stats()["context"]["host2ssd_bytes"] - w0 \
            >= m["payload_bytes"]
    assert got["step"] == 5
    for a, b in ((got["w"], tree["w"]), (got["m"][0], tree["m"][0]),
                 (got["m"][1], tree["m"][1]), (got["t"], tree["t"])):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


def _llama_state_and_step(device, cfg):
    spec = make_optimizer(warmup=2)
    return (init_train_state(cfg, spec, device=device, seed=0),
            make_train_step(cfg, spec, attn="flash", device=device))


def test_async_save_under_replays_commits_the_state_at_the_save(
        cuda_device, tmp_path):
    """The captured step replays right after AsyncCheckpointer.save
    returns, rewriting parameters, moments and lr in place while the
    commit drains: the checkpoint holds the state at the save."""
    cfg = LlamaConfig.tiny()
    batches = _token_batches(cuda_device, cfg, [(2, 64)] * 6)
    state, step = _llama_state_and_step(cuda_device, cfg)
    for b in batches[:3]:
        state, _ = step(state, b)
    at_save = [t.clone() if isinstance(t, torch.Tensor) else t
               for t in tree_flatten(train_state_tree(state))[0]]
    with _ckpt_ctx() as ctx, AsyncCheckpointer(ctx, str(tmp_path / "a")) as cp:
        cp.save(train_state_tree(state))
        for b in batches[3:]:
            state, _ = step(state, b)
        assert step.last_call == "replay"
        cp.wait()
        leaves, treedef = tree_flatten(train_state_tree(state))
        assert any(isinstance(t, torch.Tensor) and not torch.equal(t, s)
                   for t, s in zip(leaves, at_save))
        got = tree_flatten(restore_checkpoint(
            ctx, str(tmp_path / "a"), tree_unflatten(treedef, at_save)))[0]
    for a, b in zip(got, at_save):
        assert (torch.equal(a, b) and a.is_cuda) \
            if isinstance(b, torch.Tensor) else a == b


def test_load_into_a_captured_state_continues_the_run(cuda_device, tmp_path):
    """A state whose step is already captured takes a restored tree in
    place (load_train_state): its next replays, not a new capture,
    continue the uninterrupted run bit for bit."""
    cfg = LlamaConfig.tiny()
    batches = _token_batches(cuda_device, cfg, [(2, 64)] * 5)
    state, step = _llama_state_and_step(cuda_device, cfg)
    want = []
    with _ckpt_ctx() as ctx:
        for i, b in enumerate(batches):
            if i == 2:
                save_checkpoint(ctx, str(tmp_path / "c"),
                                train_state_tree(state))
            state, m = step(state, b)
            want.append((m["loss"], m["grad_norm"]))
        other, step2 = _llama_state_and_step(cuda_device, cfg)
        for b in _token_batches(cuda_device, cfg, [(2, 64)] * 3, seed=9):
            other, _ = step2(other, b)
        assert step2.last_call == "replay"
        load_train_state(other, restore_checkpoint(
            ctx, str(tmp_path / "c"), train_state_tree(other)))
    got = []
    for b in batches[2:]:
        other, m = step2(other, b)
        assert step2.last_call == "replay" and step2.graphs == 1
        got.append((m["loss"], m["grad_norm"]))
    for (a, b), (c, d) in zip(got, want[2:]):
        assert torch.equal(a, c) and torch.equal(b, d)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, other.model.state_dict()[k]), k


def test_spill_served_delivery_is_exact_on_the_card(cuda_device, tmp_path):
    """A second pass of memcpy_ssd2gpu over a working set four times the
    hot cache is served by RAM and the spill file, no source byte read,
    and lands on the card exactly."""
    rng = np.random.default_rng(21)
    path = str(tmp_path / "spill_src.bin")
    data = rng.integers(0, 1 << 15, 4 * MiB // 4, dtype=np.int32)
    data.tofile(path)
    rec = 64 * 1024
    with StromContext(StromConfig(
            hot_cache_bytes=MiB, hot_cache_admit="always",
            spill_bytes=16 * MiB, spill_dir=str(tmp_path))) as ctx:
        for epoch in range(2):
            for off in range(0, data.nbytes, rec):
                got = ctx.memcpy_ssd2gpu(path, offset=off, length=rec,
                                         dtype=np.int32, device=cuda_device,
                                         tenant="vis")
                want = torch.from_numpy(data[off // 4: (off + rec) // 4])
                assert got.is_cuda and torch.equal(got.cpu(), want)
            if epoch == 0:
                miss1 = ctx.stats()["cache"]["cache_miss_bytes"]
        st = ctx.stats()
        assert st["cache"]["cache_miss_bytes"] == miss1 == data.nbytes
        assert st["spill"]["spill_hit_bytes"] > 0
        assert st["spill"]["spill_errors"] == 0
        assert st["sched"]["sched_active_grants"] == 0


def test_cancelled_tenant_stream_releases_its_grant_on_the_card(
        cuda_device, tmp_path):
    """A tenant's streamed gather into a pinned slab, cancelled in the
    middle, hands the engine back; the next tenant's delivery to the card
    is exact."""
    rng = np.random.default_rng(22)
    path = str(tmp_path / "stream_src.bin")
    data = rng.integers(0, 256, 32 * MiB, dtype=np.uint8)
    data.tofile(path)
    from strom_torch.delivery.shard import Segment

    with StromContext(StromConfig(queue_depth=4)) as ctx:
        sched = ctx.scheduler
        slab = ctx.host_batch((16 * MiB,), cuda_device)
        segs = [Segment((2 * i + 1) * MiB, i * MiB, MiB) for i in range(16)]
        g = ctx.stream_segments(path, segs, slab, tenant="vis")
        assert sched.tenant("vis").active == 1
        g.poll(min_completions=1, timeout_s=10.0)
        g.close()
        assert sched.tenant("vis").active == 0 and sched.engine_idle()
        ctx.release_host_batch(slab, cuda_device)
        got = ctx.memcpy_ssd2gpu(path, device=cuda_device, tenant="pq")
        assert torch.equal(got.cpu(), torch.from_numpy(data))
        assert sched.tenant("pq").granted_bytes == data.nbytes
        assert ctx.stats()["sched"]["sched_active_grants"] == 0


@pytest.mark.parametrize("capture_on", ["port", "torch_default"])
def test_capture_while_another_thread_delivers(cuda_device, tmp_path,
                                               capture_on):
    """A graph captured while another thread delivers a batch whose copy
    stream is a default-priority pool stream, as a loader's first batches
    do beside a train step's capture. torch.cuda.Stream() hands those out
    round-robin, 32 to a pool, so one of the next 32 is the stream that
    torch.cuda.graph captures on by default: a delivery on that one lands
    in the capture and breaks it. The port captures on a stream of another
    pool, which none of them is, and the capture and the delivery both
    succeed, bit for bit."""
    from strom_torch.parallel.capture import CapturedStep, capture_stream

    rng = np.random.default_rng(25)
    path = str(tmp_path / "loader.bin")
    data = rng.integers(0, 256, 32 * MiB, dtype=np.uint8)
    data.tofile(path)
    if capture_on == "port":
        target = capture_stream(cuda_device)
    else:
        torch.cuda.graph(torch.cuda.CUDAGraph())   # makes the default stream
        target = torch.cuda.graph.default_capture_stream
    pool = [torch.cuda.Stream(device=cuda_device) for _ in range(32)]
    aliases = [s for s in pool if s == target]
    assert len(aliases) == (0 if capture_on == "port" else 1)
    copy_stream = aliases[0] if aliases else pool[0]

    go, landed = threading.Event(), threading.Event()
    got: dict = {}
    # pinned slabs in both cases: where the capture breaks, a slab whose
    # copy fails mid-flight still goes back, and none stays registered
    # past the context
    ctx = StromContext(StromConfig(overlap_chunk_bytes=8 * MiB,
                                   overlap_min_bytes=16 * MiB))
    ctx._copy_stream = lambda device: copy_stream

    def loader():
        try:
            go.wait(30)
            got["out"] = ctx.memcpy_ssd2gpu(path, device=cuda_device)
            torch.cuda.current_stream(cuda_device).synchronize()
        except BaseException as e:   # asserted below
            got["err"] = e
        finally:
            landed.set()

    def body(owner, x):
        owner.mul_(2).add_(x)
        go.set()   # the delivery runs on the other thread mid-capture
        assert landed.wait(60)
        owner.add_(1)
        return {"loss": owner.sum()}

    th = threading.Thread(target=loader, daemon=True)
    owner = torch.zeros(4, device=cuda_device)
    one = torch.ones(4, device=cuda_device)
    failed = []
    try:
        if capture_on == "port":
            step = CapturedStep(body, cuda_device)
            landed.set()
            step(owner, one)   # the warm-up, alone
            go.clear()
            landed.clear()
            th.start()
            step(owner, one)   # the capture, then its first replay
            assert step.last_call == "capture"
        else:
            current = torch.cuda.current_stream(cuda_device)
            th.start()
            try:
                with torch.cuda.graph(torch.cuda.CUDAGraph(),
                                      capture_error_mode="thread_local"):
                    body(owner, one)
            except RuntimeError as e:
                failed.append(e)
            finally:
                torch.cuda.set_stream(current)
    finally:
        go.set()
        th.join(60)
        torch.cuda.synchronize()
        assert ctx.stats()["slab_pool"]["slab_in_use_bytes"] == 0
        ctx.close()
        assert ctx._slab_pool.stats()["registered_slabs"] == 0
    if "err" in got:
        failed.append(got["err"])
    if capture_on == "port":
        assert not failed, failed
        assert torch.equal(got["out"].cpu(), torch.from_numpy(data))
        # the warm-up ran the body once, the capture's replay once more
        assert owner.tolist() == [6.0] * 4
    else:
        assert failed, "the capture on the aliased stream went through"


def test_failed_streamed_delivery_keeps_no_pinned_slab(cuda_device,
                                                       tmp_path):
    """A streamed delivery on pinned slabs whose piece fails more times
    than io_retries raises with every slab back in the pool; a clean
    delivery follows in the same context, exact, and another in a new
    context after the first closed, with no cudaHostRegister failure."""
    import json

    from strom_torch.engine.base import EngineError

    rng = np.random.default_rng(29)
    path = str(tmp_path / "leak.bin")
    data = rng.integers(0, 256, 32 * MiB, dtype=np.uint8)
    data.tofile(path)
    want = torch.from_numpy(data)
    # every read op over byte 20 MiB fails, twice: the op and its retry
    plan = json.dumps({"seed": 0, "rules": [
        {"kind": "errno", "op": "read", "offset_lo": 20 * MiB,
         "offset_hi": 20 * MiB + 1, "times": 2}]})
    cfg = dict(overlap_chunk_bytes=8 * MiB, overlap_min_bytes=16 * MiB,
               io_retries=1, breaker_enabled=False, residency_hybrid=False)
    ctx = StromContext(StromConfig(fault_plan=plan, **cfg))
    try:
        with pytest.raises(EngineError):
            ctx.memcpy_ssd2gpu(path, device=cuda_device)
        pool = ctx.stats()["slab_pool"]
        assert pool["slab_in_use_bytes"] == 0 and pool["parked_bytes"] == 0
        got = ctx.memcpy_ssd2gpu(path, device=cuda_device)
        assert torch.equal(got.cpu(), want)
    finally:
        ctx.close()
    assert ctx._slab_pool.stats()["registered_slabs"] == 0
    with StromContext(StromConfig(**cfg)) as again:
        got = again.memcpy_ssd2gpu(path, device=cuda_device)
        assert torch.equal(got.cpu(), want)


def test_block_until_ready_tensor_reads_on_another_stream(cuda_device,
                                                          tmp_path):
    """The async handle's full barrier: after block_until_ready() the
    delivered tensor is read on a fresh stream, with no synchronize and no
    wait_stream, and holds the file's bytes; a streamed and an unstreamed
    delivery both."""
    rng = np.random.default_rng(23)
    path = str(tmp_path / "bur.bin")
    data = rng.integers(0, 256, 48 * MiB, dtype=np.uint8)
    data.tofile(path)
    with StromContext(StromConfig(overlap_chunk_bytes=8 * MiB,
                                  overlap_min_bytes=16 * MiB)) as ctx:
        for length in (4 * MiB, data.nbytes):
            h = ctx.memcpy_ssd2gpu(path, length=length, device=cuda_device,
                                   async_=True)
            t = h.block_until_ready()
            assert h._ready and h.exception() is None and h.elapsed_s > 0
            side = torch.cuda.Stream(device=cuda_device)
            with torch.cuda.stream(side):
                host = t.to("cpu", non_blocking=False)
            assert torch.equal(host, torch.from_numpy(data[:length]))


def test_chaos_streamed_delivery_equals_clean(cuda_device, tmp_path):
    """A streamed delivery into device memory under the chaos:0 plan (EIO,
    short reads, latency spikes) lands the same bytes as a clean one; the
    plan injected faults and the retries absorbed them."""
    rng = np.random.default_rng(24)
    path = str(tmp_path / "chaos.bin")
    data = rng.integers(0, 256, 64 * MiB, dtype=np.uint8)
    data.tofile(path)
    outs = []
    for plan in ("", "chaos:0"):
        with StromContext(StromConfig(
                engine="python", residency_hybrid=False, io_retries=3,
                fault_plan=plan, overlap_chunk_bytes=8 * MiB,
                overlap_min_bytes=16 * MiB)) as ctx:
            streamed0 = _streamed(ctx)
            outs.append(ctx.memcpy_ssd2gpu(path, device=cuda_device).cpu())
            if plan:
                st = ctx.stats()
                assert st["resilience"]["fault_plan"]["faults_injected"] > 0
                assert _streamed(ctx) - streamed0 == 1
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], torch.from_numpy(data))


def test_cli_ssd2gpu_delivers_every_byte(cuda_device, tmp_path, capsys):
    """``strom_torch.cli.main(["ssd2gpu", ...])`` on the card: rc 0, the
    64 MiB in 32 MiB copies, delivered to the card; the last chunk it
    delivers equals the file's bytes."""
    import json

    from strom_torch import cli

    rc = cli.main(["ssd2gpu", "--size", str(64 * MiB), "--chunk",
                   str(32 * MiB), "--iters", "1", "--json", "--tmpdir",
                   str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["bench"] == "ssd2gpu" and out["bytes"] == 64 * MiB
    assert out["device"].startswith("cuda") and out["gbps"] > 0
    path = str(tmp_path / "strom_bench_nvme.bin")
    with StromContext() as ctx:
        got = ctx.memcpy_ssd2gpu(path, offset=32 * MiB, length=32 * MiB,
                                 device=cuda_device)
        cli._fetch_one(got)
        want = np.fromfile(path, np.uint8, count=32 * MiB,
                           offset=32 * MiB)
        assert torch.equal(got.cpu(), torch.from_numpy(want))


def _page_node(addr: int) -> int:
    """The NUMA node of the page at *addr* (get_mempolicy MPOL_F_NODE |
    MPOL_F_ADDR)."""
    import ctypes
    import platform

    nr = {"x86_64": 239, "aarch64": 236}[platform.machine()]
    libc = ctypes.CDLL(None, use_errno=True)
    node = ctypes.c_int(-1)
    rc = libc.syscall(ctypes.c_long(nr), ctypes.byref(node), None,
                      ctypes.c_ulong(0), ctypes.c_void_p(addr),
                      ctypes.c_ulong(1 | 2))
    assert rc == 0, ctypes.get_errno()
    return node.value


def test_pool_slab_pages_sit_on_the_disk_node(cuda_device, tmp_path):
    """With numa_affinity on, a pinned pool slab's pages are on the disk's
    node (bound before cudaHostRegister pinned them). Skips on a one-node
    host or where the disk reports no node."""
    import glob

    from strom_torch.probe.topology import device_for_file

    if len(glob.glob("/sys/devices/system/node/node[0-9]*")) < 2:
        pytest.skip("one NUMA node: nothing to place")
    path = str(tmp_path / "n.bin")
    np.zeros(8 * MiB, np.uint8).tofile(path)
    dev = device_for_file(path)
    if dev is None or dev.numa_node is None:
        pytest.skip("the disk reports no NUMA node")
    with StromContext(StromConfig(numa_affinity=True)) as ctx:
        ctx.memcpy_ssd2gpu(path, device=cuda_device)  # resolves the node
        slab = ctx._slab_pool.acquire(4 * MiB)
        try:
            base = buf_addr(slab)
            nodes = {_page_node(base + off)
                     for off in range(0, 4 * MiB, 1 * MiB)}
        finally:
            ctx._slab_pool.release(slab)
    assert nodes == {dev.numa_node}, nodes



@pytest.fixture()
def world_one(cuda_device):
    """A world of 1 over NCCL (an in-memory store) and its dp mesh."""
    from strom_torch.parallel import mesh

    mesh.init_distributed("cuda")
    try:
        yield mesh.make_mesh({"dp": 1})
    finally:
        mesh.shutdown()


def test_sharded_delivery_on_the_card_at_world_one(world_one, tmp_path):
    """memcpy_ssd2gpu(sharding=P("dp", None)): the global DTensor, its local
    block on this rank's card holding the file's rows; unstreamed,
    streamed, and async (block_until_ready, then read on a fresh stream)."""
    from torch.distributed.tensor import DTensor

    from strom_torch.parallel.sharding import P, TorchSharding

    rng = np.random.default_rng(29)
    path = str(tmp_path / "rows.bin")
    rows = rng.integers(0, 1 << 30, (64, 32 * 1024), dtype=np.int32)
    rows.tofile(path)
    want = torch.from_numpy(rows)
    sharding = TorchSharding(world_one, P("dp", None))
    for chunk in (0, 2 * MiB):   # 8 MiB: unstreamed, then streamed
        with StromContext(StromConfig(overlap_chunk_bytes=chunk,
                                      overlap_min_bytes=4 * MiB)) as ctx:
            before = ctx.stats()["context"]["streamed_transfers"]
            t = ctx.memcpy_ssd2gpu(path, shape=rows.shape, dtype=np.int32,
                                   sharding=sharding)
            assert isinstance(t, DTensor) and tuple(t.shape) == rows.shape
            local = t.to_local()
            assert local.device == torch.device("cuda",
                                                torch.cuda.current_device())
            assert torch.equal(local.cpu(), want)
            streamed = ctx.stats()["context"]["streamed_transfers"] - before
            assert streamed == (1 if chunk else 0)
            h = ctx.memcpy_ssd2gpu(path, shape=rows.shape, dtype=np.int32,
                                   sharding=sharding, async_=True)
            got = h.block_until_ready()
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                host = got.to_local().to("cpu", non_blocking=False)
            assert torch.equal(host, want)
            with pytest.raises(ValueError, match="not both"):
                ctx.memcpy_ssd2gpu(path, device=world_one.device_type,
                                   sharding=sharding)


def test_captured_dp_step_at_world_one(world_one):
    """The data-parallel flash step at a world of 1, captured with its NCCL
    all-reduces and fed DTensors: five steps (warm-up, capture, three
    replays) bit-equal to the step without a mesh (the mean over one rank
    is the value itself), one graph, through the flash kernels."""
    from strom_torch.parallel.sharding import P, TorchSharding

    cfg = dataclasses.replace(LlamaConfig.tiny(), n_heads=2, n_kv_heads=1)
    batches = _token_batches(torch.device("cuda"), cfg, [(2, 128)] * 5)
    sharding = TorchSharding(world_one, P("dp", None))
    out = {}
    for dp in (True, False):
        mesh = world_one if dp else None
        spec = make_optimizer(warmup=100)
        state = init_train_state(cfg, spec, device="cuda", seed=0, mesh=mesh)
        step = make_train_step(cfg, spec, attn="flash", device="cuda",
                               mesh=mesh)
        tfa.reset_launch_counts()
        metrics = []
        for b in batches:
            b = sharding.to_global(b, b.shape) if dp else b
            state, m = step(state, b)
            metrics.append((m["loss"], m["grad_norm"]))
        assert step.graphs == 1 and step.last_call == "replay"
        assert tfa.LAUNCHES["fa_fwd"] > 0 and tfa.LAUNCHES["fa_bwd_dq"] > 0
        out[dp] = (metrics, {k: v.clone() for k, v in
                             state.model.state_dict().items()})
    (got, gp), (want, wp) = out[True], out[False]
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (i, a, b)
    for k in gp:
        assert torch.equal(gp[k], wp[k]), k
