"""Expert parallelism with explicit collectives: a port-only module.

The reference jits its MoE step over a batch sharded ``P("dp"[, "sp"])``
and expert stacks sharded on the expert dimension over ``ep``
(``strom/parallel/sharding.py`` ``moe_param_shardings``); XLA's
partitioner then derives every collective of the dispatch einsums. The
port runs one process a card and places them itself:

- **the capacity queue is global.** Under jit the reference routes the
  whole ``[B, S]`` batch at once: a token's place in its expert's queue
  is its index among the tokens routed there, in the row-major order of
  the global batch, and it is kept if that place is below the capacity of
  the global token count. A rank that holds rows ``[r0, r1)`` (its dp
  block) and columns ``[c0, c1)`` of each (its sp shard) needs, for each
  of its rows and each expert, the count of tokens routed there before
  its first column: every token of the rows before, and the earlier sp
  shards' tokens of the row. :func:`queue_offsets` gathers each rank's
  per-row, per-expert counts over the ranks that hold the global batch
  (one all-gather) and takes that prefix; the same counts give the global
  share of tokens each expert got (the load-balance loss's ``frac``);
- **experts over ep, tokens replicated over ep.** The ranks of one ep
  group hold the same tokens (the batch is not split over ep). Each
  computes its ``E/ep`` experts on the tokens routed to them and the
  partial outputs are summed over ep (``reduce_from_tp`` on the ep axis).
  In the backward each ep rank then holds only its experts' share of the
  gradient of the expert inputs and of the gate, so both pass through
  ``copy_to_tp`` on ep; the router's logits and the auxiliary losses do
  not (every ep rank computes them whole: an all-reduce would count them
  ep times). ``models/moe.py`` ``moe_ffn`` applies both.

Each rank thus repeats the attention and routing of its ep group's
tokens; an all-to-all over ep that splits them is a later design.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from strom_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """Where this rank's ``[B, S]`` tokens lie in the global batch: row
    block *row* of *rows* (dp) and column shard *col* of *cols* (sp) of
    each row. *group*: the process group of the ``rows × cols`` ranks that
    hold the blocks; *order*: for each block in row-major (row, col) order,
    its place in the group's rank order (the order an all-gather returns),
    None where the two agree. *group* None: one rank, which then holds the
    whole batch."""
    rows: int = 1
    cols: int = 1
    row: int = 0
    col: int = 0
    group: Any = None
    order: tuple[int, ...] | None = None

    @property
    def size(self) -> int:
        return self.rows * self.cols


def token_layout(mesh: Mesh | None, sp: bool) -> TokenLayout:
    """The layout of the token batch that ``make_moe_train_step(mesh=,
    sp=)`` takes: rows split over dp, and with *sp* each row's columns over
    sp (without it the sp ranks hold the same rows: replicas, which route
    alike). The mesh's axes may come in any order: the blocks are placed
    by each member's dp and sp coordinates, not by its rank."""
    if mesh is None:
        return TokenLayout()
    axes = ("dp", "sp") if sp else ("dp",)
    rows, cols = mesh.axis_size("dp"), mesh.axis_size("sp") if sp else 1
    if rows * cols == 1:
        return TokenLayout()
    group = mesh.group(*axes)
    members = dist.get_process_group_ranks(group)
    coords = list(mesh.coords(dist.get_rank()))
    blocks = []
    for row in range(rows):
        for col in range(cols):
            for a, i in zip(axes, (row, col)):
                if a in mesh.axis_names:
                    coords[mesh.axis_names.index(a)] = i
            blocks.append(members.index(int(mesh.devices[tuple(coords)])))
    order = tuple(blocks)
    return TokenLayout(rows, cols, mesh.axis_index("dp"),
                       mesh.axis_index("sp") if sp else 0, group,
                       None if order == tuple(range(len(order))) else order)


def queue_offsets(counts: torch.Tensor, layout: TokenLayout
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """*counts* ``[B, E]`` int64: the tokens of each of this rank's rows
    routed to each expert. Returns (``[B, E]``: for each row and expert,
    the tokens of the global batch routed there before this rank's first
    column of the row, in row-major order; ``[E]``: the global batch's
    tokens routed to each expert). One all-gather over the layout's group;
    static shapes, no host sync (a CUDA graph captures it)."""
    B, E = counts.shape
    if layout.group is None:
        return torch.cumsum(counts, 0) - counts, counts.sum(0)
    counts = counts.contiguous()
    gathered = counts.new_empty((layout.size * B, E))
    dist.all_gather_into_tensor(gathered, counts, group=layout.group)
    gathered = gathered.view(layout.size, B, E)
    if layout.order is not None:
        gathered = torch.stack([gathered[i] for i in layout.order])
    # (row block, col shard, row, expert) -> global (row, col) order
    g = gathered.view(layout.rows, layout.cols, B, E).transpose(1, 2)
    flat = g.reshape(-1, E)
    before = (torch.cumsum(flat, 0) - flat).view(layout.rows, B,
                                                 layout.cols, E)
    return before[layout.row, :, layout.col], flat.sum(0)
