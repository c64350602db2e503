"""Flash attention: hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the autograd ``Function`` over them.

Counterpart of ``strom/ops/flash_attention.py``, with its signature and
layout: q ``[B, S, H, Dh]``, k and v ``[B, S, KV, Dh]`` (GQA, q head h reads
kv head h // (H / KV)), out ``[B, S, H, Dh]``, and the per-row logsumexp
``lse`` in the ``[B, H, S, 1]`` f32 layout. The three Pallas kernels map to
CUDA kernels under ``strom_torch/csrc/``; ``kernel_route`` picks the kernel
by dtype and padded head width:

======================  ====================================  ==========================  =====================
Pallas (TPU)            bf16 (H100, sm_90a)                   float32 (H100, sm_90a)      plain PyTorch version
======================  ====================================  ==========================  =====================
``_fa_kernel``          ``fa_fwd_wgmma_kernel`` (sm90 file)   ``fa_fwd_kernel``           ``_flash_fwd_plain``
``_fa_bwd_dkv_kernel``  ``fa_bwd_dkv_wgmma_kernel`` (sm90)    ``fa_bwd_dkv_kernel``       ``_flash_bwd_plain``
``_fa_bwd_dq_kernel``   ``fa_bwd_dq_wgmma_kernel`` (sm90)     ``fa_bwd_dq_kernel``        ``_flash_bwd_plain``
======================  ====================================  ==========================  =====================

``flash_attention_sm90.cu`` holds the bf16 tensor-core kernels (wgmma, TMA)
for heads up to 256; ``flash_attention.cu`` the scalar-FMA kernels, which
take f32 at every head and bf16 heads wider than 256. The
source note in each ``.cu`` file says what bounds its kernels on the card
and what their design does about it. Dispatch is by the tensors' device, never
by a failure: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``_delta`` (Δ = rowsum(dO ∘ O)) was an XLA-fused reduce in
the reference and is a torch op here.

The kernels take every head dim the reference takes. A head the kernels
are not built for is zero-padded to the next width they are (64, or a
multiple of 128: ``kernel_head_dim``) and the outputs sliced
back: exact, since zero columns add nothing to q·kᵀ, give zero output and
gradient columns and leave Δ unchanged; the scale stays 1/sqrt(Dh) of the
real width. Any S the blocks divide runs: the kernels mask the ragged
last tile themselves.

``_flash_fwd``/``_flash_bwd`` keep the reference's block-pair contract:
``_flash_bwd(..., delta=)`` takes an explicit global ``lse`` and Δ, so ring
attention can reuse the kernels per (q block, kv block) pair.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import math

import torch
import torch.nn.functional as F

from strom_torch.ops import build

_NEG_BIG = -0.7 * torch.finfo(torch.float32).max
KERNEL_TILE = 64   # the CUDA kernels' q and kv tile (rows)
KERNEL_HEAD_DIMS = (64, 128)   # the widths a head up to 128 pads to
WIDE_CHUNK = 128   # above 128 the scalar kernels take multiples of this
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention.cu"
_SOURCE_SM90 = "flash_attention_sm90.cu"

# Launches per kernel: each wrapper adds one where it launches its kernel,
# under the kernel's name in LAUNCHES and under the variant that ran in
# VARIANT_LAUNCHES (``variant``: name, library and dtype). Under a CUDA
# graph capture nothing runs: ``counting_capture`` takes the capture's
# counts back out, and each replay adds them (``count_replay``).
LAUNCHES: collections.Counter = collections.Counter(
    {"fa_fwd": 0, "fa_bwd_dkv": 0, "fa_bwd_dq": 0})
VARIANT_LAUNCHES: collections.Counter = collections.Counter()
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def variant(name: str, library: str, dtype: torch.dtype) -> str:
    """The ``VARIANT_LAUNCHES`` key of kernel *name* launched from
    *library* (``"sm90"`` or ``"scalar"``, as ``kernel_route`` says) on
    inputs of *dtype*: e.g. ``"fa_fwd@sm90/bf16"``."""
    return f"{name}@{library}/{_DTYPE_NAMES[dtype]}"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    VARIANT_LAUNCHES.clear()


@contextlib.contextmanager
def counting_capture():
    """Around a CUDA graph capture, where the wrappers run but no kernel
    does: yields a Counter that receives, by variant, the launches the
    captured work records, and leaves both counters as they were. Each
    replay of the graph then adds them with :func:`count_replay`, so the
    counters keep counting launches that ran on the device."""
    launches, variants = collections.Counter(LAUNCHES), \
        collections.Counter(VARIANT_LAUNCHES)
    captured: collections.Counter = collections.Counter()
    try:
        yield captured
    finally:
        captured.update(VARIANT_LAUNCHES - variants)
        for counter, before in ((LAUNCHES, launches), (VARIANT_LAUNCHES, variants)):
            counter.clear()
            counter.update(before)


def count_replay(captured: collections.Counter) -> None:
    """Count the launches one replay of a graph ran: *captured*, as
    :func:`counting_capture` gave it."""
    for key, n in captured.items():
        VARIANT_LAUNCHES[key] += n
        LAUNCHES[key.split("@", 1)[0]] += n


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
                                        i, i, i, i, i, i, f, p]
        lib.strom_fa_bwd_dkv.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                         i, i, i, i, i, i, f, p]
        for fn in (lib.strom_fa_fwd, lib.strom_fa_bwd_dq, lib.strom_fa_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.strom_cuda_error_string.argtypes = [i]
        lib.strom_cuda_error_string.restype = ctypes.c_char_p
        lib._strom_typed = True
    return lib


def _sm90_lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE_SM90)
    if not getattr(lib, "_strom_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.strom_fa_fwd_sm90.argtypes = [i, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.strom_fa_bwd_dkv_sm90.argtypes = [i, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, i, f, p]
        lib.strom_fa_bwd_dq_sm90.argtypes = [i, p, p, p, p, p, p, p,
                                             i, i, i, i, i, i, f, p]
        for fn in (lib.strom_fa_fwd_sm90, lib.strom_fa_bwd_dkv_sm90,
                   lib.strom_fa_bwd_dq_sm90):
            fn.restype = ctypes.c_int
        lib._strom_typed = True
    return lib


def kernel_head_dim(Dh: int) -> int:
    """The width the wrappers zero-pad a head of *Dh* to: 64 or 128 (the
    widths of both kernel families), above 128 the next multiple of
    ``WIDE_CHUNK`` (the scalar kernels, which take any such width; the
    three wgmma kernels take 256 too)."""
    if Dh < 1:
        raise ValueError(f"head dim must be positive, got {Dh}")
    for width in KERNEL_HEAD_DIMS:
        if Dh <= width:
            return width
    return -(-Dh // WIDE_CHUNK) * WIDE_CHUNK


def pad_head(t: torch.Tensor, width: int) -> torch.Tensor:
    """*t* [..., Dh] zero-padded to [..., width] (itself when Dh == width)."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _rows_padded(t: torch.Tensor, S: int) -> torch.Tensor:
    """lse or Δ [B,H,S,1] as rows of SL = S rounded up to the kernels' tile:
    the backward kernels' bulk copies read whole 64-row runs from
    16-byte-aligned rows. A copy only where S is ragged; otherwise *t*
    itself, whose memory already has that layout."""
    pad = -S % KERNEL_TILE
    return F.pad(t.reshape(t.shape[0], t.shape[1], S), (0, pad)) if pad else t


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """*t*, or a copy of it where its data does not start on a 16-byte
    boundary (a contiguous view at an odd offset)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_operands(width: int, typed: tuple, rows: tuple = ()
                    ) -> tuple[tuple, tuple, int]:
    """What a kernel reads, prepared for both routes: *typed* (q, k, v and
    dO) zero-padded to the kernel's head *width* (``pad_head``), *rows*
    (lse and Δ, [B,H,S,1]) as rows of SL = S rounded up to the tile
    (``_rows_padded``), and each of them 16-byte aligned (``_aligned16``):
    the sm90 kernels read through TMA maps and ``cp.async.bulk``, the
    scalar ones by 16-byte ``cp.async``, and all of these need 16-byte
    aligned addresses. Returns (typed, rows, SL); a tensor that needs none
    of this is returned itself, so aligned inputs at the kernel's width
    cost no copy."""
    S = typed[0].shape[1]
    typed = tuple(_aligned16(pad_head(t, width)) for t in typed)
    rows = tuple(_aligned16(_rows_padded(t, S)) for t in rows)
    return typed, rows, S + -S % KERNEL_TILE


def _check_kernel_inputs(typed: tuple, rows: tuple = ()) -> None:
    """*typed*: q, k, v (and dO) of one float32/bfloat16 dtype; *rows*: the
    f32 lse/delta columns."""
    q = typed[0]
    kernel_head_dim(q.shape[-1])
    for t in typed + rows:
        if not t.is_cuda or t.device != q.device:
            raise ValueError("all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("CUDA flash attention needs contiguous inputs")
    for t in typed:
        if t.dtype != q.dtype or t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"CUDA flash attention takes float32 or bfloat16 "
                             f"q/k/v/dO of one dtype, got {t.dtype}")


# A launcher returns 0, a cudaError_t, or one of these (the .cu files').
_LAUNCH_ERRORS = {-1: "unsupported dtype/head dim",
                  -2: "the driver has no cuTensorMapEncodeTiled",
                  -3: "cuTensorMapEncodeTiled refused a tensor map"}


def _launch(name: str, library: str, dtype: torch.dtype, fn, *args) -> None:
    """Call launcher *fn* of kernel *name* in *library*; count the launch,
    or raise if *fn* refused it."""
    rc = fn(*args)
    if rc != 0:
        msg = _LAUNCH_ERRORS.get(rc) or \
            _kernel_lib().strom_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed ({rc}): {msg}")
    LAUNCHES[name] += 1
    VARIANT_LAUNCHES[variant(name, library, dtype)] += 1


# The padded head widths the sm90 (wgmma) kernels take in bf16, by kernel.
SM90_WIDTHS = {"fa_fwd": (64, 128, 256), "fa_bwd_dkv": (64, 128, 256),
               "fa_bwd_dq": (64, 128, 256)}


def kernel_route(name: str, dtype: torch.dtype, width: int) -> str:
    """The library that launches kernel *name* (a ``LAUNCHES`` key) for
    inputs of *dtype* zero-padded to *width*: ``"sm90"`` (the wgmma kernels
    of flash_attention_sm90.cu) for bf16 at the widths in ``SM90_WIDTHS``,
    64, 128 and 256 for all three kernels; else ``"scalar"``
    (flash_attention.cu): f32 at every width, bf16 above 256."""
    return "sm90" if dtype == torch.bfloat16 and width in SM90_WIDTHS[name] \
        else "scalar"


def _unpad(t: torch.Tensor, Dh: int) -> torch.Tensor:
    return t if t.shape[-1] == Dh else t[..., :Dh].contiguous()


def _flash_fwd_kernel(q, k, v, *, causal: bool):
    """The kernel ``kernel_route`` names: wgmma or scalar."""
    _check_kernel_inputs((q, k, v))
    B, S, H, Dh = q.shape
    width = kernel_head_dim(Dh)
    (q, k, v), _, _ = kernel_operands(width, (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S, 1), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], int(causal),
            1.0 / math.sqrt(Dh))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        library = kernel_route("fa_fwd", q.dtype, width)
        if library == "sm90":
            _launch("fa_fwd", library, q.dtype, _sm90_lib().strom_fa_fwd_sm90,
                    width, *ptrs, stream)
        else:
            _launch("fa_fwd", library, q.dtype, _kernel_lib().strom_fa_fwd,
                    _KERNEL_DTYPES[q.dtype], width, *ptrs, stream)
    return _unpad(out, Dh), lse


def _bwd_launch(name: str, q, k, v, g, lse, delta, outs, causal: bool):
    """Launch backward kernel *name* writing *outs* (tensors shaped as the
    padded q or k): (q, k, v, dO) at the kernel's head width, lse and Δ as
    [B,H,SL] rows, scale 1/sqrt(Dh) of the real head."""
    B, S, H, Dh = q.shape
    width = kernel_head_dim(Dh)
    library = kernel_route(name, q.dtype, width)
    (q, k, v, g), (lse, delta), SL = kernel_operands(width, (q, k, v, g),
                                                     (lse, delta))
    args = (width, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            B, S, SL, H, k.shape[2], int(causal), 1.0 / math.sqrt(Dh))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if library == "sm90":
            _launch(name, library, q.dtype,
                    getattr(_sm90_lib(), f"strom_{name}_sm90"), *args, stream)
        else:
            _launch(name, library, q.dtype,
                    getattr(_kernel_lib(), f"strom_{name}"),
                    _KERNEL_DTYPES[q.dtype], *args, stream)


def _check_bwd_inputs(q, k, v, g, lse, delta) -> None:
    _check_kernel_inputs((q, k, v, g), (lse, delta))
    B, S, H, _ = q.shape
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 \
            or lse.numel() != B * H * S or delta.numel() != B * H * S:
        raise ValueError("lse and delta must be [B,H,S,1] float32")


def _padded_empty(t: torch.Tensor) -> torch.Tensor:
    """An output shaped as *t* at the kernels' head width."""
    return t.new_empty((*t.shape[:-1], kernel_head_dim(t.shape[-1])))


def _bwd_dkv_kernel(q, k, v, g, lse, delta, *, causal: bool):
    """The kernel ``kernel_route`` names: wgmma or scalar."""
    _check_bwd_inputs(q, k, v, g, lse, delta)
    dk, dv = _padded_empty(k), _padded_empty(v)
    _bwd_launch("fa_bwd_dkv", q, k, v, g, lse, delta, (dk, dv), causal)
    Dh = k.shape[-1]
    return _unpad(dk, Dh), _unpad(dv, Dh)


def _bwd_dq_kernel(q, k, v, g, lse, delta, *, causal: bool):
    """The kernel ``kernel_route`` names: wgmma or scalar."""
    _check_bwd_inputs(q, k, v, g, lse, delta)
    dq = _padded_empty(q)
    _bwd_launch("fa_bwd_dq", q, k, v, g, lse, delta, (dq,), causal)
    return _unpad(dq, q.shape[-1])


def _flash_bwd_kernel(q, k, v, g, lse, delta, *, causal: bool):
    dk, dv = _bwd_dkv_kernel(q, k, v, g, lse, delta, causal=causal)
    return _bwd_dq_kernel(q, k, v, g, lse, delta, causal=causal), dk, dv


# ------------------------------------------------------ plain versions
def _flash_fwd_plain(q, k, v, *, causal: bool, block_q: int, block_k: int,
                     scale: float | None = None):
    """The Pallas forward's blockwise online softmax in eager torch: f32
    scores and statistics, p cast to v's dtype before p·v as on the TPU.
    *scale* defaults to 1/sqrt(Dh) (another one: a zero-padded head)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    blk_q, blk_k = _blocks(S, block_q, block_k)
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
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
                     block_k: int, scale: float | None = None):
    """Both Pallas backward kernels' arithmetic in eager torch: P rebuilt
    from (q, k, lse) per block pair, dV += Pᵀ dO, dS = P ∘ (dO Vᵀ − Δ) ·
    scale, dK += dSᵀ Q, dQ += dS K, with f32 sums."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    blk_q, blk_k = _blocks(S, block_q, block_k)
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
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
