"""Flash attention: hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the autograd ``Function`` over them.

Counterpart of ``strom/ops/flash_attention.py``, with its signature and
layout: q ``[B, S, H, Dh]``, k and v ``[B, S, KV, Dh]`` (GQA, q head h reads
kv head h // (H / KV)), out ``[B, S, H, Dh]``, and the per-row logsumexp
``lse`` in the ``[B, H, S, 1]`` f32 layout. The three Pallas kernels map to
three CUDA kernels in ``strom_torch/csrc/flash_attention.cu``:

=======================  ==========================  =====================
Pallas (TPU)             CUDA (H100, sm_90a)         plain PyTorch version
=======================  ==========================  =====================
``_fa_kernel``           ``fa_fwd_kernel``           ``_flash_fwd_plain``
``_fa_bwd_dkv_kernel``   ``fa_bwd_dkv_kernel``       ``_flash_bwd_plain``
``_fa_bwd_dq_kernel``    ``fa_bwd_dq_kernel``        ``_flash_bwd_plain``
=======================  ==========================  =====================

The source note in the ``.cu`` file says what bounds each kernel on the card
and what its design does about it. Dispatch is by the tensors' device, never
by a failure: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``_delta`` (Δ = rowsum(dO ∘ O)) was an XLA-fused reduce in
the reference and is a torch op here.

``_flash_fwd``/``_flash_bwd`` keep the reference's block-pair contract:
``_flash_bwd(..., delta=)`` takes an explicit global ``lse`` and Δ, so ring
attention can reuse the kernels per (q block, kv block) pair.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from strom_torch.ops import build

_NEG_BIG = -0.7 * torch.finfo(torch.float32).max
KERNEL_TILE = 64   # the CUDA kernels' q and kv tile (rows)
KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention.cu"

# Launches per kernel: each wrapper adds one where it launches its kernel.
LAUNCHES: collections.Counter = collections.Counter(
    {"fa_fwd": 0, "fa_bwd_dkv": 0, "fa_bwd_dq": 0})


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _blocks(S: int, block_q: int, block_k: int) -> tuple[int, int]:
    blk_q, blk_k = min(block_q, S), min(block_k, S)
    if S % blk_q or S % blk_k:
        raise ValueError(f"seq len {S} must divide by blocks ({blk_q},{blk_k})")
    return blk_q, blk_k


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,H,Dh], k/v [B,S,KV,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, Dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != Dh \
            or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")


# --------------------------------------------------------------- kernels
def _kernel_lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_strom_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.strom_fa_fwd.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.strom_fa_bwd_dq.argtypes = [i, i, p, p, p, p, p, p, p,
                                        i, i, i, i, i, f, p]
        lib.strom_fa_bwd_dkv.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, f, p]
        for fn in (lib.strom_fa_fwd, lib.strom_fa_bwd_dq, lib.strom_fa_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.strom_cuda_error_string.argtypes = [i]
        lib.strom_cuda_error_string.restype = ctypes.c_char_p
        lib._strom_typed = True
    return lib


def _check_kernel_inputs(typed: tuple, rows: tuple = ()) -> None:
    """*typed*: q, k, v (and dO) of one float32/bfloat16 dtype; *rows*: the
    f32 lse/delta columns."""
    q = typed[0]
    B, S, H, Dh = q.shape
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"CUDA flash attention supports head dims "
                         f"{KERNEL_HEAD_DIMS}, got {Dh}")
    if S % KERNEL_TILE:
        raise ValueError(f"CUDA flash attention needs seq len divisible by "
                         f"{KERNEL_TILE}, got {S}")
    for t in typed + rows:
        if not t.is_cuda or t.device != q.device:
            raise ValueError("all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("CUDA flash attention needs contiguous inputs")
    for t in typed:
        if t.dtype != q.dtype or t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"CUDA flash attention takes float32 or bfloat16 "
                             f"q/k/v/dO of one dtype, got {t.dtype}")


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = "unsupported dtype/head dim" if rc < 0 else \
            _kernel_lib().strom_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed ({rc}): {msg}")
    LAUNCHES[name] += 1


def _flash_fwd_kernel(q, k, v, *, causal: bool):
    _check_kernel_inputs((q, k, v))
    B, S, H, Dh = q.shape
    lib = _kernel_lib()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("fa_fwd", lib.strom_fa_fwd, _KERNEL_DTYPES[q.dtype], Dh,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, S, H, k.shape[2], int(causal),
                1.0 / math.sqrt(Dh), stream)
    return out, lse


def _bwd_args(q, k, v, g, lse, delta):
    _check_kernel_inputs((q, k, v, g), (lse, delta))
    B, S, H, Dh = q.shape
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 \
            or lse.numel() != B * H * S or delta.numel() != B * H * S:
        raise ValueError("lse and delta must be [B,H,S,1] float32")
    return (_KERNEL_DTYPES[q.dtype], Dh, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr())


def _bwd_dkv_kernel(q, k, v, g, lse, delta, *, causal: bool):
    args = _bwd_args(q, k, v, g, lse, delta)
    B, S, H, Dh = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("fa_bwd_dkv", _kernel_lib().strom_fa_bwd_dkv, *args,
                dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2],
                int(causal), 1.0 / math.sqrt(Dh),
                torch.cuda.current_stream().cuda_stream)
    return dk, dv


def _bwd_dq_kernel(q, k, v, g, lse, delta, *, causal: bool):
    args = _bwd_args(q, k, v, g, lse, delta)
    B, S, H, Dh = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("fa_bwd_dq", _kernel_lib().strom_fa_bwd_dq, *args,
                dq.data_ptr(), B, S, H, k.shape[2], int(causal),
                1.0 / math.sqrt(Dh), torch.cuda.current_stream().cuda_stream)
    return dq


def _flash_bwd_kernel(q, k, v, g, lse, delta, *, causal: bool):
    dk, dv = _bwd_dkv_kernel(q, k, v, g, lse, delta, causal=causal)
    return _bwd_dq_kernel(q, k, v, g, lse, delta, causal=causal), dk, dv


# ------------------------------------------------------ plain versions
def _flash_fwd_plain(q, k, v, *, causal: bool, block_q: int, block_k: int):
    """The Pallas forward's blockwise online softmax in eager torch: f32
    scores and statistics, p cast to v's dtype before p·v as on the TPU."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    blk_q, blk_k = _blocks(S, block_q, block_k)
    scale = 1.0 / math.sqrt(Dh)
    qt = q.permute(0, 2, 1, 3).reshape(B, KV, G, S, Dh)
    kt = k.permute(0, 2, 1, 3).unsqueeze(2)   # [B,KV,1,S,Dh]
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)
    out = torch.empty((B, KV, G, S, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, KV, G, S, 1), dtype=torch.float32, device=q.device)
    for i in range(S // blk_q):
        q0 = i * blk_q
        qb = qt[..., q0:q0 + blk_q, :].float()
        m = torch.full((B, KV, G, blk_q, 1), _NEG_BIG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, G, blk_q, Dh), device=q.device)
        for j in range(S // blk_k):
            k0 = j * blk_k
            if causal and k0 > q0 + blk_q - 1:
                break
            s = torch.matmul(qb, kt[..., k0:k0 + blk_k, :].float()
                             .transpose(-1, -2)) * scale
            if causal:
                qpos = torch.arange(q0, q0 + blk_q, device=q.device)[:, None]
                kpos = torch.arange(k0, k0 + blk_k, device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, _NEG_BIG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_new
            vb = vt[..., k0:k0 + blk_k, :]
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        denom = torch.clamp(l, min=1e-30)
        out[..., q0:q0 + blk_q, :] = (acc / denom).to(q.dtype)
        lse[..., q0:q0 + blk_q, :] = m + torch.log(denom)
    out = out.reshape(B, H, S, Dh).permute(0, 2, 1, 3).contiguous()
    return out, lse.reshape(B, H, S, 1)


def _flash_bwd_plain(q, k, v, g, lse, delta, *, causal: bool, block_q: int,
                     block_k: int):
    """Both Pallas backward kernels' arithmetic in eager torch: P rebuilt
    from (q, k, lse) per block pair, dV += Pᵀ dO, dS = P ∘ (dO Vᵀ − Δ) ·
    scale, dK += dSᵀ Q, dQ += dS K, with f32 sums."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    blk_q, blk_k = _blocks(S, block_q, block_k)
    scale = 1.0 / math.sqrt(Dh)
    qt = q.permute(0, 2, 1, 3).reshape(B, KV, G, S, Dh)
    gt = g.permute(0, 2, 1, 3).reshape(B, KV, G, S, Dh)
    kt = k.permute(0, 2, 1, 3).unsqueeze(2)
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)
    lse_t = lse.reshape(B, KV, G, S, 1).float()
    dlt_t = delta.reshape(B, KV, G, S, 1).float()
    dq = torch.zeros((B, KV, G, S, Dh), device=q.device)
    dk = torch.zeros((B, KV, S, Dh), device=q.device)
    dv = torch.zeros((B, KV, S, Dh), device=q.device)
    for j in range(S // blk_k):
        k0 = j * blk_k
        kb = kt[..., k0:k0 + blk_k, :]
        vb = vt[..., k0:k0 + blk_k, :]
        for i in range(S // blk_q):
            q0 = i * blk_q
            if causal and q0 + blk_q - 1 < k0:
                continue
            qb = qt[..., q0:q0 + blk_q, :]
            gb = gt[..., q0:q0 + blk_q, :]
            s = torch.matmul(qb.float(), kb.float().transpose(-1, -2)) * scale
            p = torch.exp(s - lse_t[..., q0:q0 + blk_q, :])
            if causal:
                qpos = torch.arange(q0, q0 + blk_q, device=q.device)[:, None]
                kpos = torch.arange(k0, k0 + blk_k, device=q.device)[None, :]
                p = torch.where(qpos >= kpos, p, 0.0)
            pb = p.to(v.dtype).float()
            dv[..., k0:k0 + blk_k, :] += torch.matmul(
                pb.transpose(-1, -2), gb.float()).sum(2)
            dp = torch.matmul(gb.float(), vb.float().transpose(-1, -2))
            ds = p * (dp - dlt_t[..., q0:q0 + blk_q, :]) * scale
            dk[..., k0:k0 + blk_k, :] += torch.matmul(
                ds.to(q.dtype).float().transpose(-1, -2), qb.float()).sum(2)
            dq[..., q0:q0 + blk_q, :] += torch.matmul(
                ds.to(k.dtype).float(), kb.float())
    dq = dq.reshape(B, H, S, Dh).permute(0, 2, 1, 3).to(q.dtype).contiguous()
    dk = dk.permute(0, 2, 1, 3).to(k.dtype).contiguous()
    dv = dv.permute(0, 2, 1, 3).to(v.dtype).contiguous()
    return dq, dk, dv


# ------------------------------------------------------------ dispatch
def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) in the kernels' [B,H,S,1] f32 layout (the same
    as lse)."""
    d = (g.float() * out.float()).sum(-1)          # [B,S,H]
    return d.permute(0, 2, 1).unsqueeze(-1).contiguous()


def _flash_fwd(q, k, v, *, causal: bool, block_q: int = 128,
               block_k: int = 128):
    """q [B,S,H,Dh]; k,v [B,S,KV,Dh] → (out [B,S,H,Dh], lse [B,H,S,1])."""
    _check_shapes(q, k, v)
    _blocks(q.shape[1], block_q, block_k)
    if q.is_cuda:
        return _flash_fwd_kernel(q, k, v, causal=causal)
    return _flash_fwd_plain(q, k, v, causal=causal, block_q=block_q,
                            block_k=block_k)


def _flash_bwd(q, k, v, out, lse, g, *, causal: bool, block_q: int = 128,
               block_k: int = 128, delta=None):
    """Blockwise backward → (dq, dk, dv). With delta=None this is the vjp of
    the single-device forward; an explicit global (lse, delta) pair makes it
    the block-pair primitive ring attention needs."""
    _check_shapes(q, k, v)
    _blocks(q.shape[1], block_q, block_k)
    if delta is None:
        delta = _delta(out, g)
    if q.is_cuda:
        return _flash_bwd_kernel(q, k, v, g, lse, delta, causal=causal)
    return _flash_bwd_plain(q, k, v, g, lse, delta, causal=causal,
                            block_q=block_q, block_k=block_k)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = _flash_fwd(q, k, v, causal=causal, block_q=block_q,
                              block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_k = ctx.cfg
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, g.contiguous(),
                                causal=causal, block_q=block_q,
                                block_k=block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention. q [B,S,H,Dh]; k,v [B,S,KV,Dh] (GQA) → [B,S,H,Dh].
    Differentiable in q, k and v through the blockwise backward."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


def _dense_ref(q, k, v, causal: bool):
    """f32 dense attention: the parity oracle for tests."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(Dh)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(B, S, H, Dh)


def make_flash_attention(*, block_q: int = 128, block_k: int = 128,
                         causal: bool = True):
    """An ``attn_fn`` for ``strom_torch.models.llama.Llama(attn_fn=...)``."""

    def attn(q, k, v):
        return flash_attention(q, k, v, causal, block_q, block_k)

    return attn
