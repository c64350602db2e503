"""The PyTorch port on the card: the CUDA flash-attention kernels against
their plain versions, delivery into device memory with slab recycling, and
a train step that goes through the kernels. Every test is marked ``cuda``
and skips without a CUDA device. This file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.models.llama import LlamaConfig
from strom_torch.ops import flash_attention as tfa
from strom_torch.parallel.train import init_train_state, make_train_step

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
                                         (2, 128, 4, 4, 128)])
def test_kernels_match_plain(cuda_device, dtype, causal, B, S, H, KV, Dh):
    """Each CUDA kernel against its plain version on the same inputs, the
    plain version in f32. f32: sums in another order (1e-4); bf16: the
    kernels round their outputs to bf16 (2^-9 relative), so 1e-2 relative
    plus 1e-3 of the largest value. lse is f32 in both: 1e-3 absolute."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, g = (torch.randn(*s, generator=gen, device=cuda_device).to(dtype)
                  for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh),
                            (B, S, H, Dh)))
    before = dict(tfa.LAUNCHES)
    out, lse = tfa._flash_fwd(q, k, v, causal=causal)
    delta = tfa._delta(out, g)
    grads = tfa._flash_bwd(q, k, v, out, lse, g, causal=causal, delta=delta)
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        "fa_fwd": 1, "fa_bwd_dkv": 1, "fa_bwd_dq": 1}
    f = [t.float() for t in (q, k, v, g)]
    pout, plse = tfa._flash_fwd_plain(*f[:3], causal=causal, block_q=64,
                                      block_k=64)
    pgrads = tfa._flash_bwd_plain(*f, lse, delta, causal=causal, block_q=64,
                                  block_k=64)
    rtol, frac = (1e-4, 1e-5) if dtype == torch.float32 else (1e-2, 1e-3)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    for got, want in zip((out, *grads), (pout, *pgrads)):
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=frac * want.abs().max().item())


def test_kernel_wrapper_raises_on_unsupported_cuda_input(cuda_device):
    """A CUDA tensor the kernel does not take raises; nothing falls back to
    the plain version."""
    q = torch.zeros(1, 128, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 128, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 2, 128, device=cuda_device).transpose(1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q, q, q)


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
        a = ctx.memcpy_ssd2gpu(path, length=6 * MiB, device=cuda_device)
        b = ctx.memcpy_ssd2gpu(
            path, length=6 * MiB, device=cuda_device, async_=True).result(60)
        torch.cuda.synchronize()
        assert torch.equal(a, want) and torch.equal(b, want)
        st = ctx.stats()
        assert st["streamed_transfers"] == 2
        assert st["slab_pool"]["hits"] > 0 and st["slab_pool"]["pinned_bytes"] > 0
        small = ctx.memcpy_ssd2gpu(path, offset=4096, shape=(256, 256),
                                   dtype=np.int32, device=cuda_device)
        torch.cuda.synchronize()
        assert torch.equal(small.cpu(), torch.from_numpy(
            data[4096: 4096 + 256 * 256 * 4].view(np.int32).reshape(256, 256)))
    finally:
        ctx.close()


def test_train_step_goes_through_the_kernels(cuda_device):
    cfg = dataclasses.replace(LlamaConfig.tiny(), d_model=256, n_heads=2,
                              n_kv_heads=1)   # head dim 128
    state = init_train_state(cfg, device=cuda_device, seed=0)
    step = make_train_step(cfg, attn="flash", device=cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128), dtype=np.int32)).to(cuda_device)
    tfa.reset_launch_counts()
    losses = []
    for _ in range(2):
        state, m = step(state, tokens)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses))
    # forward + remat recompute per layer and step; one of each backward
    assert dict(tfa.LAUNCHES) == {"fa_fwd": 8, "fa_bwd_dkv": 4, "fa_bwd_dq": 4}
