"""Shardings over a :class:`~strom_torch.parallel.mesh.Mesh` (the port's
counterpart of ``strom/parallel/sharding.py`` and of the parts of
``jax.sharding`` the data path reads).

``P`` is a ``PartitionSpec``: one entry per array dimension, each None
(replicated), a mesh axis name, or a tuple of names (the dimension split
over several axes, the first the major one). ``TorchSharding(mesh, spec)``
answers what ``NamedSharding`` answers for the planner: which block of a
global array every mesh position holds (``devices_indices_map``, keyed by
rank) and which block this process holds (``addressable_devices_indices_
map``: one rank, one card, so one entry). A global array is a ``DTensor``
over the mesh's ``DeviceMesh`` (``to_global``).

As in JAX, a dimension that its axes do not divide raises ``ValueError``;
``DTensor``'s ``Shard`` alone would split it unevenly, as ``torch.chunk``
does. The Llama and MoE rules are data: :func:`shard_params` keeps this
rank's block of each parameter by them, and :func:`gather_params` puts
the blocks back together.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Sequence

import torch

from strom_torch.parallel.mesh import Mesh, group_device, rank as _rank


class P(tuple):
    """PartitionSpec: ``P("dp", None)``, ``P(("dp", "sp"))``, ``P()``."""

    def __new__(cls, *parts: Any) -> "P":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


def _axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class TorchSharding:
    """*spec* laid over *mesh*. Every rank of the mesh holds one block of
    the global array; the blocks along a dimension are the mixed-radix
    position of the rank over that dimension's axes."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)
        used: list[str] = []
        for entry in self.spec:
            for ax in _axes(entry):
                if ax not in mesh.axis_names:
                    raise ValueError(f"axis {ax!r} of {self.spec} is not in "
                                     f"the mesh's {mesh.axis_names}")
                if ax in used:
                    raise ValueError(f"axis {ax!r} appears twice in "
                                     f"{self.spec}")
                used.append(ax)

    def __repr__(self) -> str:
        return f"TorchSharding({self.mesh!r}, {self.spec!r})"

    @property
    def device_set(self) -> frozenset[int]:
        """The mesh's ranks."""
        return frozenset(int(r) for r in self.mesh.devices.ravel())

    def _splits(self, shape: Sequence[int]) -> list[tuple[str, ...]]:
        """Each dimension's axes, checked against *shape*: no more entries
        than dimensions, and every sharded dimension divisible."""
        shape = tuple(shape)
        if any(e is not None for e in self.spec[len(shape):]):
            raise ValueError(f"{self.spec} shards a dimension past the rank "
                             f"{len(shape)} of {shape}")
        sizes = self.mesh.shape
        out = []
        for d, dim in enumerate(shape):
            axes = _axes(self.spec[d]) if d < len(self.spec) else ()
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(
                    f"{self!r} implies that array axis {d} is partitioned "
                    f"{n} times, but the dimension size is {dim} (full "
                    f"shape: {shape})")
            out.append(axes)
        return out

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        sizes = self.mesh.shape
        return tuple(dim // math.prod(sizes[a] for a in axes)
                     for dim, axes in zip(shape, self._splits(shape)))

    def _index(self, coords: tuple[int, ...], shape: Sequence[int],
               splits: list[tuple[str, ...]]) -> tuple[slice, ...]:
        pos = dict(zip(self.mesh.axis_names, coords))
        sizes = self.mesh.shape
        index = []
        for dim, axes in zip(shape, splits):
            if not axes:
                index.append(slice(None))
                continue
            block = 0
            for a in axes:                       # first axis the major one
                block = block * sizes[a] + pos[a]
            step = dim // math.prod(sizes[a] for a in axes)
            index.append(slice(block * step, (block + 1) * step))
        return tuple(index)

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> dict[int, tuple[slice, ...]]:
        """{rank: the block it holds} for every position of the mesh."""
        splits = self._splits(shape)
        return {int(self.mesh.devices[c]): self._index(c, shape, splits)
                for c in itertools.product(*map(range,
                                                self.mesh.devices.shape))}

    def addressable_devices_indices_map(self, shape: Sequence[int]
                                        ) -> dict[torch.device,
                                                  tuple[slice, ...]]:
        """{this rank's device: the block it holds}; empty where this rank
        is not in the mesh."""
        splits = self._splits(shape)
        coords = self.mesh.coords(_rank())
        if coords is None:
            return {}
        return {group_device(): self._index(coords, shape, splits)}

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh axis: ``Shard(d)`` where the axis
        splits dimension d, else ``Replicate()``. A dimension split over
        several axes must name them in mesh order (DTensor splits in that
        order)."""
        from torch.distributed.tensor import Replicate, Shard

        out: list = [Replicate()] * len(self.mesh.axis_names)
        for d, entry in enumerate(self.spec):
            axes = _axes(entry)
            order = [self.mesh.axis_names.index(a) for a in axes]
            if order != sorted(order):
                raise NotImplementedError(
                    f"dimension {d} of {self.spec} is split over "
                    f"{axes}, not in the mesh's axis order "
                    f"{self.mesh.axis_names}: no DTensor placement says so")
            for i in order:
                out[i] = Shard(d)
        return tuple(out)

    def to_global(self, local: torch.Tensor, shape: Sequence[int]):
        """This rank's block *local* as the global ``DTensor`` of *shape*."""
        from torch.distributed.tensor import DTensor

        shape = tuple(int(s) for s in shape)
        if tuple(local.shape) != self.shard_shape(shape):
            raise ValueError(f"local block {tuple(local.shape)} is not the "
                             f"shard {self.shard_shape(shape)} of {shape}")
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * shape[i + 1]
        return DTensor.from_local(local, self.mesh.device_mesh,
                                  self.placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=tuple(stride))


def local_tensor(t: Any) -> Any:
    """A DTensor's local block; any other value as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


# Per-parameter PartitionSpecs of strom_torch.models.llama's parameters,
# keyed as the reference keys its pytree (stacked layers under "layers").
# The stacked layers' leading axis carries "pp"; column-parallel (output dim
# on tp) feeding row-parallel (input dim on tp) pairs keep activations
# tp-local between the two matmuls.
_LLAMA_RULES = {
    ("embed",): P(None, "tp"),
    ("layers", "attn_norm"): P("pp"),
    ("layers", "wq"): P("pp", None, "tp"),
    ("layers", "wk"): P("pp", None, "tp"),
    ("layers", "wv"): P("pp", None, "tp"),
    ("layers", "wo"): P("pp", "tp", None),
    ("layers", "mlp_norm"): P("pp"),
    ("layers", "w_gate"): P("pp", None, "tp"),
    ("layers", "w_up"): P("pp", None, "tp"),
    ("layers", "w_down"): P("pp", "tp", None),
    ("final_norm",): P(),
    ("lm_head",): P(None, "tp"),
}
# MoE variant (strom_torch.models.moe): attention rules shared with llama;
# the expert stacks [L, E, ...] carry the ep axis on the expert dim, tp on
# the hidden dim within each expert.
_MOE_RULES = {
    **_LLAMA_RULES,
    ("layers", "router"): P("pp"),
    ("layers", "w_gate"): P("pp", "ep", None, "tp"),
    ("layers", "w_up"): P("pp", "ep", None, "tp"),
    ("layers", "w_down"): P("pp", "ep", "tp", None),
}
_TOP_LEVEL = ("embed", "final_norm", "lm_head")


def _specs(params: dict, rules: dict) -> dict[str, P]:
    return {name: rules.get(
        (name,) if name in _TOP_LEVEL else ("layers", name), P())
        for name in params}


def param_specs(params: dict) -> dict[str, P]:
    """{parameter name: PartitionSpec} for a Llama state dict (names as
    ``Llama.named_parameters`` gives them; the stacked layer tensors are
    the reference's ``layers`` subtree)."""
    return _specs(params, _LLAMA_RULES)


def moe_param_specs(params: dict) -> dict[str, P]:
    """:func:`param_specs` for an MoE state dict."""
    return _specs(params, _MOE_RULES)


def restrict(spec: P, mesh: Mesh) -> P:
    """*spec* on *mesh*: an axis the mesh doesn't have (e.g. tp on a dp×sp
    mesh) degrades to replicated on that dim."""
    return P(*(ax if ax in mesh.axis_names else None for ax in spec))


def param_shardings(params: dict, mesh: Mesh) -> dict[str, TorchSharding]:
    """Specs restricted to the mesh's axes (:func:`restrict`)."""
    return {name: TorchSharding(mesh, restrict(spec, mesh))
            for name, spec in param_specs(params).items()}


def moe_param_shardings(params: dict, mesh: Mesh
                        ) -> dict[str, TorchSharding]:
    """:func:`param_shardings` for an MoE state dict: the expert stacks
    split on dim 1 over ep."""
    return {name: TorchSharding(mesh, restrict(spec, mesh))
            for name, spec in moe_param_specs(params).items()}


def shard_params(params: dict[str, torch.Tensor], mesh: Mesh, *,
                 shardings=param_shardings) -> dict[str, torch.Tensor]:
    """This rank's block of each full parameter in *params*, by
    ``shardings(params, mesh)`` (:func:`param_shardings` for a Llama state
    dict, :func:`moe_param_shardings` for an MoE one): views of
    *params*."""
    out = {}
    for name, sh in shardings(params, mesh).items():
        t = params[name]
        (index,) = sh.addressable_devices_indices_map(t.shape).values()
        out[name] = t[index]
    return out


def gather_params(local: dict[str, torch.Tensor], mesh: Mesh, *,
                  shardings=param_shardings) -> dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params` with the same *shardings*: each
    parameter whole, from every rank's block (a collective call of every
    rank of *mesh*)."""
    out = {}
    sizes = mesh.shape
    for name, sh in shardings(local, mesh).items():
        t = local[name]
        if all(e is None for e in sh.spec):
            out[name] = t
            continue
        shape = [dim * math.prod(sizes[a] for a in _axes(entry))
                 for dim, entry in itertools.zip_longest(
                     t.shape, sh.spec[:t.dim()])]
        out[name] = sh.to_global(t.contiguous(), shape).full_tensor()
    return out


def batch_spec(*, sp: bool = False) -> P:
    """Token batches: batch on dp, optionally sequence on sp (long-context
    loaders deliver sequence-sharded batches)."""
    return P("dp", "sp") if sp else P("dp")


def batch_sharding(mesh: Mesh, *, sp: bool = False) -> TorchSharding:
    """The sharding of a [batch, seq_len + 1] token batch that
    ``make_train_step(mesh=, sp=)`` takes: :func:`batch_spec` restricted to
    the mesh's axes, so rows (sequences) are replicated where the mesh has
    no dp (sp) axis."""
    return TorchSharding(mesh, restrict(P("dp", "sp" if sp else None), mesh))
