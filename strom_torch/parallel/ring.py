"""Ring attention: exact causal attention over sequence-sharded activations
(the port's counterpart of ``strom/parallel/ring.py``; long-context /
context parallelism).

Each process holds one block of the sequence, ``[B_l, S_l, H_l, Dh]``
(its rows of the batch, its heads under tp), and computes its q block
against the whole sequence: at each step a local q-block × kv-block
partial, merged by online softmax, then the kv block moves one hop around
the ring. Communication is O(S/n) a step, n steps: about one all-gather in
all, but one kv block a process at a time.

Where the reference runs inside ``shard_map`` and ``lax.ppermute``
rotates the blocks, the port runs one process per card and
:func:`ppermute` sends and receives them with ``dist.batch_isend_irecv``
over the axis's process group (NCCL on the card, gloo on the CPU); a block
a permutation sends to its own process is copied. Each function takes a
:class:`~strom_torch.parallel.mesh.AxisGroup` where the reference takes
an axis name: the rank's index and the size the reference reads from
``lax.axis_index`` and ``lax.axis_size``.

A process knows its own index, so the flash rings skip a block that
causality hides from all its queries (a kv block from later in the
sequence) rather than compute and mask it as the reference's uniform
``lax.scan`` does: the masked merge is an exact identity (weight
``exp(-huge)`` = 0), so the results are the same. Every process still
takes part in every rotation. The dense ring computes and masks every
block, as the reference does: autograd runs its rotations' backward
exchanges, and they need the same graph on every rank.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
import torch.distributed as dist

from strom_torch.ops.flash_attention import (_NEG_BIG, _delta, _flash_bwd,
                                             _flash_fwd)
from strom_torch.parallel.mesh import AxisGroup, Mesh

Perm = Sequence[tuple[int, int]]


def _shift(n: int) -> list[tuple[int, int]]:
    """One hop around the ring: i → i + 1."""
    return [(i, (i + 1) % n) for i in range(n)]


def _exchange(tensors: Sequence[torch.Tensor], perms: Sequence[Perm],
              axis: AxisGroup) -> list[torch.Tensor]:
    """``lax.ppermute`` of each tensor under its permutation of the axis's
    indices (pairs (source, destination); every index once on each side),
    all in one ``batch_isend_irecv``. Returns what arrives here. Not
    differentiable: :func:`ppermute` is."""
    n, i = axis.size, axis.index
    outs, ops = [], []
    for tag, (t, perm) in enumerate(zip(tensors, perms)):
        to = dict(perm)
        if sorted(to) != list(range(n)) or sorted(to.values()) != list(range(n)):
            raise ValueError(f"{list(perm)} is not a permutation of the "
                             f"{n} indices of axis {axis.name!r}")
        if to[i] == i:           # to itself: a copy (gloo refuses a self-send)
            outs.append(t.clone())
            continue
        src = next(s for s, d in to.items() if d == i)
        t = t.contiguous()
        out = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, axis.ranks[to[i]], axis.group,
                              tag=tag))
        ops.append(dist.P2POp(dist.irecv, out, axis.ranks[src], axis.group,
                              tag=tag))
        outs.append(out)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return outs


def _inverse(perm: Perm) -> tuple[tuple[int, int], ...]:
    return tuple((d, s) for s, d in perm)


class _PPermute(torch.autograd.Function):
    """``_exchange`` whose backward sends each gradient back along the
    inverse permutation (the transpose ``lax.ppermute`` has in JAX)."""

    @staticmethod
    def forward(ctx, perms, axis, *tensors):
        ctx.perms, ctx.axis = perms, axis
        return tuple(_exchange(tensors, perms, axis))

    @staticmethod
    def backward(ctx, *grads):
        back = _exchange(grads, [_inverse(p) for p in ctx.perms], ctx.axis)
        return (None, None, *back)


def ppermute_many(tensors: Sequence[torch.Tensor], perms: Sequence[Perm],
                  axis: AxisGroup) -> tuple[torch.Tensor, ...]:
    """:func:`ppermute` of several tensors, each under its own permutation,
    in one exchange."""
    perms = tuple(tuple(map(tuple, p)) for p in perms)
    return _PPermute.apply(perms, axis, *tensors)


def ppermute(x: torch.Tensor, perm: Perm, axis: AxisGroup) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)``: process of index s sends *x* to the
    process of index d for each (s, d) in *perm* (a permutation of the
    axis's indices) and returns what it receives. Differentiable: the
    gradient goes back along the inverse permutation."""
    return ppermute_many([x], [perm], axis)[0]


# ------------------------------------------------------------ dense ring
def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos0: int, k_pos0: int, causal: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One q-block × kv-block partial: returns (scores_max [B,KV,G,Sq],
    exp-scores @ v [B,Sq,KV,G,Dh], row denominators) in float32."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(Dh)
    if causal:
        qpos = q_pos0 + torch.arange(Sq, device=q.device)
        kpos = k_pos0 + torch.arange(k.shape[1], device=q.device)
        scores = torch.where(qpos[:, None] >= kpos[None, :], scores, _NEG_BIG)
    m = scores.amax(-1)                                  # [B,KV,G,Sq]
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)                                        # [B,KV,G,Sq]
    pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v).float()
    return m, pv, l


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, axis: AxisGroup, causal: bool = True
                         ) -> torch.Tensor:
    """The dense ring (the parity oracle): q,k,v are this process's
    sequence block ([B,Sq,H,Dh] / [B,Sk,KV,Dh]); returns the exact attention
    output of the local q block against the whole (ring-assembled)
    sequence. Differentiable by autograd through :func:`ppermute`."""
    n, idx = axis.size, axis.index
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    m = torch.full((B, KV, G, Sq), _NEG_BIG, device=q.device)
    l = torch.zeros((B, KV, G, Sq), device=q.device)
    acc = torch.zeros((B, Sq, KV, G, Dh), device=q.device)
    k_blk, v_blk = k, v
    for s in range(n):
        if s:   # rotate one hop, THEN compute: n-1 rotations in all
            k_blk, v_blk = ppermute_many([k_blk, v_blk], [_shift(n)] * 2, axis)
        src = (idx - s) % n        # whose kv block we hold at step s
        # a hidden block is computed and masked too: its rotation's
        # backward is an exchange every rank must take part in, so each
        # rank's autograd graph must use every rotated block
        bm, pv, bl = _block_attn(q, k_blk, v_blk, idx * Sq, src * Sk, causal)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)   # m starts at finite _NEG_BIG: no nan
        beta = torch.exp(bm - m_new)
        l = l * alpha + bl * beta
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] \
            + pv * beta.permute(0, 3, 1, 2)[..., None]
        m = m_new
    denom = l.permute(0, 3, 1, 2)[..., None]
    out = acc / torch.clamp(denom, min=1e-30)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


# ------------------------------------------------------------ ring × flash
# Each ring step runs the port's flash kernels (ops/flash_attention.py) on
# (local q block, rotating kv block) and the partials merge by logsumexp.
# With equal sequence shards causality has three static cases: the
# DIAGONAL block (src == idx) is the ordinary aligned causal kernel, earlier
# blocks (src < idx) are fully visible (causal=False), later ones hidden.
#
# The backward is a second ring pass: the forward's GLOBAL logsumexp and
# Δ = rowsum(dO∘O) of the local q rows feed the blockwise backward kernels
# (_flash_bwd(delta=)), which then give each (q block, kv block) pair's
# exact share of the global gradient. The dK/dV accumulators travel WITH
# their kv block and take one final hop home.


def _lse_merge(o: torch.Tensor, lse: torch.Tensor, o_b: torch.Tensor,
               lse_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two attention partials, each normalized w.r.t. its own
    logsumexp. o [B,S,H,Dh] f32; lse [B,H,S,1] f32 (the kernels' layout)."""
    lse_new = torch.logaddexp(lse, lse_b)
    w = torch.exp(lse - lse_new).permute(0, 2, 1, 3)      # [B,S,H,1]
    w_b = torch.exp(lse_b - lse_new).permute(0, 2, 1, 3)
    return o * w + o_b * w_b, lse_new


def _ring_flash_fwd_impl(q, k, v, axis: AxisGroup, causal: bool,
                         block_q: int, block_k: int):
    n, idx = axis.size, axis.index
    fwd = partial(_flash_fwd, block_q=block_q, block_k=block_k)
    o, lse = fwd(q, k, v, causal=causal)
    o = o.float()
    k_blk, v_blk = k, v
    for s in range(1, n):
        k_blk, v_blk = _exchange([k_blk, v_blk], [_shift(n)] * 2, axis)
        src = (idx - s) % n
        if causal and src > idx:
            continue
        o_b, lse_b = fwd(q, k_blk, v_blk, causal=False)
        o, lse = _lse_merge(o, lse, o_b.float(), lse_b)
    return o.to(q.dtype), lse


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, block_q, block_k):
        out, lse = _ring_flash_fwd_impl(q, k, v, axis, causal, block_q,
                                        block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (axis, causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        axis, causal, block_q, block_k = ctx.cfg
        n, idx = axis.size, axis.index
        g = g.contiguous()
        # Δ over the GLOBAL output's local rows, in the kernels' layout
        delta = _delta(out, g)

        def pair(k_blk, v_blk, blk_causal):
            return _flash_bwd(q, k_blk, v_blk, out, lse, g, causal=blk_causal,
                              block_q=block_q, block_k=block_k, delta=delta)

        dq, dk, dv = (t.float() for t in pair(k, v, causal))   # diagonal
        k_blk, v_blk = k, v
        for s in range(1, n):
            # the gradient accumulators travel WITH their kv block
            k_blk, v_blk, dk, dv = _exchange([k_blk, v_blk, dk, dv],
                                             [_shift(n)] * 4, axis)
            src = (idx - s) % n
            if causal and src > idx:
                continue
            dq_c, dk_c, dv_c = pair(k_blk, v_blk, False)
            dq = dq + dq_c.float()
            dk = dk + dk_c.float()
            dv = dv + dv_c.float()
        if n > 1:   # after n-1 rotations each kv block sits one hop short
            dk, dv = _exchange([dk, dv], [_shift(n)] * 2, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_flash_attention_local(q, k, v, axis: AxisGroup, causal: bool = True,
                               block_q: int = 128, block_k: int = 128):
    """Ring attention running the flash kernels per block, forward and
    backward. Same contract as :func:`ring_attention_local`."""
    return _RingFlash.apply(q, k, v, axis, causal, block_q, block_k)


# ------------------------------------------------------- zigzag (balanced)
# The plain causal ring idles about half its processes: at ring step s a
# process whose kv source is "in its future" has nothing to do. The zigzag
# layout splits the sequence into 2n chunks and gives process i chunks
# (i, 2n−1−i): one early and one late, so each ring step leaves every
# process the same visible work. The permutes of the entry and exit are
# pure chunk routing, outside the core's autograd Function (their own
# backward is the inverse permutation); RoPE was applied before attention on
# the contiguous layout, and the output returns to contiguous order.
#
# Per ring step the core runs 3 half-chunk flash calls: (q_early·kv_early)
# visible when src < idx, (q_late·kv_early) always visible, (q_late·kv_late)
# visible when src > idx; of the two that causality decides, one runs.


def _zigzag_perms(n: int) -> tuple[list, list]:
    """owner(c) = c if c < n else 2n−1−c: where chunk 2i (perm_a) and chunk
    2i+1 (perm_b) of process i's contiguous shard go. Both are full
    bijections."""
    perm_a = [(i, 2 * i if 2 * i < n else 2 * n - 1 - 2 * i)
              for i in range(n)]
    perm_b = [(i, 2 * i + 1 if 2 * i + 1 < n else 2 * n - 2 - 2 * i)
              for i in range(n)]
    return perm_a, perm_b


def _zigzag_entry(x: torch.Tensor, axis: AxisGroup
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous shard (chunks 2i, 2i+1) → zigzag pair (chunk i, 2n−1−i).
    x: [B, Sl, ...] with Sl even. Returns (early, late), each [B, Sl/2, ...]."""
    h0, h1 = x.chunk(2, dim=1)
    ra, rb = ppermute_many([h0, h1], _zigzag_perms(axis.size), axis)
    # process d's early chunk is d (even → ra, odd → rb); late is 2n−1−d
    return (ra, rb) if axis.index % 2 == 0 else (rb, ra)


def _zigzag_exit(early: torch.Tensor, late: torch.Tensor, axis: AxisGroup
                 ) -> torch.Tensor:
    """Inverse of :func:`_zigzag_entry`: zigzag pair → contiguous shard."""
    perm_a, perm_b = _zigzag_perms(axis.size)
    even = axis.index % 2 == 0
    # chunk 2i's slot is early on an even process, late on an odd one
    pay_a, pay_b = (early, late) if even else (late, early)
    h0, h1 = ppermute_many([pay_a, pay_b],
                           [_inverse(perm_a), _inverse(perm_b)], axis)
    return torch.cat([h0, h1], dim=1)


def _halves(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    a, b = t.chunk(2, dim=1)
    return a.contiguous(), b.contiguous()


def _zz_pairs(q1, q2, k1, k2, v1, v2, src: int, idx: int, fwd_state, fwd):
    """One zigzag ring step's half-chunk flash calls, merged into the
    per-half running (o, lse) state. src: whose kv pair we hold (chunk ids
    b1=src, b2=2n−1−src); q halves are chunks a1=idx, a2=2n−1−idx."""
    (o1, l1), (o2, l2) = fwd_state
    if src < idx:    # a1 (early) vs b1: fully visible
        u1o, u1l = fwd(q1, k1, v1, causal=False)
        o1, l1 = _lse_merge(o1, l1, u1o.float(), u1l)
    u2o, u2l = fwd(q2, k1, v1, causal=False)   # a2 (late) vs b1: always
    o2, l2 = _lse_merge(o2, l2, u2o.float(), u2l)
    if src > idx:    # a2 vs b2: a later early chunk ⇒ an EARLIER late one
        u3o, u3l = fwd(q2, k2, v2, causal=False)
        o2, l2 = _lse_merge(o2, l2, u3o.float(), u3l)
    return (o1, l1), (o2, l2)


def _zz_fwd_impl(q, k, v, axis: AxisGroup, block_q: int, block_k: int):
    n, idx = axis.size, axis.index
    fwd = partial(_flash_fwd, block_q=block_q, block_k=block_k)
    # inputs arrive ALREADY in zigzag order (early ‖ late): just split
    q1, q2 = _halves(q)
    k1, k2 = _halves(k)
    v1, v2 = _halves(v)
    # step 0: own kv pair; the two diagonals run the causal kernel
    o1, l1 = fwd(q1, k1, v1, causal=True)
    o2a, l2a = fwd(q2, k1, v1, causal=False)
    o2b, l2b = fwd(q2, k2, v2, causal=True)
    state = ((o1.float(), l1),
             _lse_merge(o2a.float(), l2a, o2b.float(), l2b))
    kk1, kk2, vv1, vv2 = k1, k2, v1, v2
    for s in range(1, n):
        kk1, kk2, vv1, vv2 = _exchange([kk1, kk2, vv1, vv2],
                                       [_shift(n)] * 4, axis)
        state = _zz_pairs(q1, q2, kk1, kk2, vv1, vv2, (idx - s) % n, idx,
                          state, fwd)
    (o1, l1), (o2, l2) = state
    return (o1.to(q.dtype), o2.to(q.dtype)), (l1, l2), (q1, q2, k1, k2, v1,
                                                        v2)


class _ZZCore(torch.autograd.Function):
    """The zigzag ring on inputs in zigzag order; output in zigzag order."""

    @staticmethod
    def forward(ctx, q, k, v, axis, block_q, block_k):
        (o1, o2), (l1, l2), zz = _zz_fwd_impl(q, k, v, axis, block_q, block_k)
        ctx.save_for_backward(*zz, o1, o2, l1, l2)
        ctx.cfg = (axis, block_q, block_k)
        return torch.cat([o1, o2], dim=1)

    @staticmethod
    def backward(ctx, g):
        q1, q2, k1, k2, v1, v2, o1, o2, l1, l2 = ctx.saved_tensors
        axis, block_q, block_k = ctx.cfg
        n, idx = axis.size, axis.index
        g1, g2 = _halves(g)
        d1 = _delta(o1, g1)
        d2 = _delta(o2, g2)

        def pair(qh, gh, oh, lh, dh, kb, vb, causal):
            return (t.float() for t in _flash_bwd(
                qh, kb, vb, oh, lh, gh, causal=causal, block_q=block_q,
                block_k=block_k, delta=dh))

        # step 0: own kv pair (diagonals causal)
        dq1, dk1, dv1 = pair(q1, g1, o1, l1, d1, k1, v1, True)
        dq2a, dk1b, dv1b = pair(q2, g2, o2, l2, d2, k1, v1, False)
        dq2b, dk2, dv2 = pair(q2, g2, o2, l2, d2, k2, v2, True)
        dq2 = dq2a + dq2b
        dk1 = dk1 + dk1b
        dv1 = dv1 + dv1b
        kk1, kk2, vv1, vv2 = k1, k2, v1, v2
        for s in range(1, n):
            kk1, kk2, vv1, vv2, dk1, dk2, dv1, dv2 = _exchange(
                [kk1, kk2, vv1, vv2, dk1, dk2, dv1, dv2], [_shift(n)] * 8,
                axis)
            src = (idx - s) % n
            if src < idx:
                u_dq1, u_dk1, u_dv1 = pair(q1, g1, o1, l1, d1, kk1, vv1,
                                           False)
                dq1 = dq1 + u_dq1
                dk1 = dk1 + u_dk1
                dv1 = dv1 + u_dv1
            u_dq2, u_dk1b, u_dv1b = pair(q2, g2, o2, l2, d2, kk1, vv1, False)
            dq2 = dq2 + u_dq2
            dk1 = dk1 + u_dk1b
            dv1 = dv1 + u_dv1b
            if src > idx:
                u_dq2b, u_dk2, u_dv2 = pair(q2, g2, o2, l2, d2, kk2, vv2,
                                            False)
                dq2 = dq2 + u_dq2b
                dk2 = dk2 + u_dk2
                dv2 = dv2 + u_dv2
        # kv (and their grads) sit one hop short of home after n−1 rotations
        dk1, dk2, dv1, dv2 = _exchange([dk1, dk2, dv1, dv2], [_shift(n)] * 4,
                                       axis)
        return (torch.cat([dq1, dq2], dim=1).to(q1.dtype),
                torch.cat([dk1, dk2], dim=1).to(k1.dtype),
                torch.cat([dv1, dv2], dim=1).to(v1.dtype), None, None, None)


def zigzag_ring_flash_local(q, k, v, axis: AxisGroup, block_q: int = 128,
                            block_k: int = 128):
    """Causal ring × flash on the zigzag layout. Same contract as
    :func:`ring_attention_local`: contiguous sequence shards in, contiguous
    exact-attention output out; the zigzag relayout is internal."""
    if axis.size == 1:
        return ring_flash_attention_local(q, k, v, axis, True, block_q,
                                          block_k)
    if q.shape[1] % 2:
        raise ValueError(f"zigzag needs an even per-device sequence length, "
                         f"got {q.shape[1]} (the shard splits into an "
                         "early and a late half-chunk)")
    qz = torch.cat(_zigzag_entry(q, axis), dim=1)
    kz = torch.cat(_zigzag_entry(k, axis), dim=1)
    vz = torch.cat(_zigzag_entry(v, axis), dim=1)
    oz = _ZZCore.apply(qz, kz, vz, axis, block_q, block_k)
    o1, o2 = oz.chunk(2, dim=1)
    return _zigzag_exit(o1, o2, axis)


def make_ring_attention_local(impl: str, *, axis: AxisGroup,
                              causal: bool = True, block_q: int = 128,
                              block_k: int = 128):
    """The ring body for *impl* on local blocks over *axis*: shared by
    :func:`make_ring_attention` and the pipelined step. One dispatch, one
    place to tune block sizes."""
    if impl not in ("dense", "flash", "zigzag"):
        raise ValueError(
            f"impl must be 'dense', 'flash' or 'zigzag', got {impl!r}")
    if impl == "zigzag" and not causal:
        raise ValueError("zigzag balances the CAUSAL ring; use impl='flash' "
                         "for non-causal attention")
    if impl == "zigzag":
        return lambda q, k, v: zigzag_ring_flash_local(q, k, v, axis,
                                                       block_q, block_k)
    if impl == "flash":
        return lambda q, k, v: ring_flash_attention_local(
            q, k, v, axis, causal, block_q, block_k)
    return partial(ring_attention_local, axis=axis, causal=causal)


def make_ring_attention(mesh: Mesh, *, axis: str = "sp",
                        batch_axis: str = "dp", head_axis: str = "tp",
                        causal: bool = True, impl: str = "dense",
                        block_q: int = 128, block_k: int = 128):
    """An ``attn_fn`` for ``strom_torch.models.llama`` that runs the ring
    algorithm over the mesh's *axis*. It takes this process's blocks, q
    ``[B_l, S_l, H_l, Dh]`` and k, v ``[B_l, S_l, KV_l, Dh]``, and returns
    the output block of the same shape: the reference's ``shard_map`` with
    specs ``P(batch_axis, axis, head_axis, None)`` around the same body.
    Batch and heads stay split over *batch_axis* and *head_axis* as they
    arrive (n_kv_heads must divide by the tp size); only *axis* takes
    part in the ring. *axis* may not be one of them.

    impl="flash" runs the flash kernels per ring block (forward AND
    blockwise backward: the long-context training path); "dense" is the
    plain online-softmax ring (parity oracle, short sequences); "zigzag" is
    the load-balanced causal flash ring (internal zigzag relayout; causal
    only)."""
    if axis in (batch_axis, head_axis):
        raise ValueError(f"the ring axis {axis!r} is also the batch or head "
                         f"axis ({batch_axis!r}, {head_axis!r})")
    return make_ring_attention_local(impl, axis=mesh.axis(axis),
                                     causal=causal, block_q=block_q,
                                     block_k=block_k)
