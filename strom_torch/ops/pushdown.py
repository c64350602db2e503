"""Near-data pushdown (the port's copy of ``strom/ops/pushdown.py``): run
the query's work inside the delivery path instead of after it.

**Predicate IR + plan-time refutation.** A small declarative predicate
language (``col("value") > 0``, combinable with ``&`` / ``|``) that the
parquet scan planner evaluates against row-group column STATISTICS during
the footer walk it already does. A row group whose min/max provably refute
the predicate is never submitted: its chunks never enter the ExtentList,
never ride the engine, never decode. Missing or partial statistics
conservatively pass (a group we cannot refute is read), so pushed-down
results are bit-identical to post-hoc filtering of the unpushed read; the
``parquet_pushdown_*`` counters record what was skipped.

**OpGraph.** The fusable ``filter/project/cast/normalize`` per-sample
operator chain, compiled once per pipeline (output shape/dtype derived by a
dry run on a zero sample) and run between decode completion and the
host-to-device copy, in numpy on the host. The fused and unfused paths call
the same per-sample kernel, so outputs are bit-identical. A sample the
``filter`` op rejects is ZEROED and counted (``ops_filter_dropped``),
consistent with the decode-error policy: dropping rows would break static
batch shapes.

Refutation rule (the conservative core): comparisons against min/max only
refute what numpy comparison semantics could never match. NaN rows (nulls
decoded as NaN) satisfy no ordered comparison and no ``==``, so min/max of
the non-null values refute those safely; ``!=`` additionally requires a
known-zero null count, because a NaN row WOULD match ``!=``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
from strom_torch.utils.locks import make_lock

# the pushdown counters: the parquet scan planner feeds them into the
# context's counters (ctx.stats())
PUSHDOWN_FIELDS = (
    "parquet_pushdown_groups_total",
    "parquet_pushdown_groups_skipped",
    "parquet_pushdown_skipped_bytes",
    "parquet_pushdown_submitted_bytes",
    "parquet_pushdown_rows_masked",
)

# the columns of the reference bench's pushed-vs-unpushed A/B, kept with
# their names for the port's bench (ROADMAP Queue A item 10)
PUSHDOWN_BENCH_FIELDS = (
    "pushdown_ok",
    "parquet_pushdown_rows_per_s",
    "parquet_unpushed_rows_per_s",
    "parquet_pushdown_vs_unpushed",
    "parquet_pushdown_skipped_bytes",
    "parquet_pushdown_submitted_bytes",
    "parquet_pushdown_groups_skipped",
    "parquet_pushdown_groups_total",
    "dist_peer_raw_wire_bytes",
    "dist_peer_comp_wire_bytes",
    "dist_peer_comp_vs_raw",
    "peer_comp_ratio",
)

# the OpGraph counters (per-op engagement proof): the vision pipeline
# moves them into the context's counters once a batch
OPS_FIELDS = (
    "ops_graph_samples",
    "ops_graph_runs",
    "ops_filter_samples",
    "ops_filter_dropped",
    "ops_project_samples",
    "ops_cast_samples",
    "ops_normalize_samples",
)


class ColStats(NamedTuple):
    """One column's row-group statistics; ``None`` = unknown (conservative:
    an unknown bound refutes nothing)."""

    min: Any
    max: Any
    null_count: "int | None"


class Predicate:
    """Base of the declarative predicate IR. Build leaves with
    :func:`col`; combine with ``&`` (AND) and ``|`` (OR)."""

    def columns(self) -> frozenset:
        raise NotImplementedError

    def refutes(self, stats: "dict[str, ColStats]") -> bool:
        """True iff *stats* PROVE no row of the group can match. Missing
        stats always return False — never refute what you cannot see."""
        raise NotImplementedError

    def mask(self, cols: "dict[str, np.ndarray]") -> np.ndarray:
        """Boolean row mask over decoded column arrays — the post-decode
        half that keeps pushed results bit-identical to post-hoc filters."""
        raise NotImplementedError

    def __and__(self, other: "Predicate") -> "Predicate":
        return And((self, other))

    def __or__(self, other: "Predicate") -> "Predicate":
        return Or((self, other))


_OPS = ("<", "<=", ">", ">=", "==", "!=")


@dataclasses.dataclass(frozen=True)
class Cmp(Predicate):
    """``col <op> literal`` — the IR leaf."""

    col: str
    op: str
    value: Any

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}, got {self.op!r}")

    def columns(self) -> frozenset:
        return frozenset((self.col,))

    def refutes(self, stats: "dict[str, ColStats]") -> bool:
        st = stats.get(self.col)
        if st is None or st.min is None or st.max is None:
            return False  # no (full) stats: conservatively pass
        v = self.value
        try:
            if self.op == ">":
                return bool(st.max <= v)
            if self.op == ">=":
                return bool(st.max < v)
            if self.op == "<":
                return bool(st.min >= v)
            if self.op == "<=":
                return bool(st.min > v)
            if self.op == "==":
                return bool(v < st.min or v > st.max)
            # "!=": every non-null value equals v AND there are no nulls
            # (a null decodes to NaN, and NaN != v would match)
            return bool(st.min == v and st.max == v and st.null_count == 0)
        except TypeError:
            # incomparable stats type (e.g. bytes stats vs numeric literal):
            # treat as missing stats
            return False

    def mask(self, cols: "dict[str, np.ndarray]") -> np.ndarray:
        a = cols[self.col]
        v = self.value
        if self.op == ">":
            return a > v
        if self.op == ">=":
            return a >= v
        if self.op == "<":
            return a < v
        if self.op == "<=":
            return a <= v
        if self.op == "==":
            return a == v
        return a != v


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    terms: tuple

    def columns(self) -> frozenset:
        return frozenset().union(*(t.columns() for t in self.terms))

    def refutes(self, stats: "dict[str, ColStats]") -> bool:
        # one refuted conjunct refutes the conjunction
        return any(t.refutes(stats) for t in self.terms)

    def mask(self, cols: "dict[str, np.ndarray]") -> np.ndarray:
        m = self.terms[0].mask(cols)
        for t in self.terms[1:]:
            m = np.logical_and(m, t.mask(cols))
        return m


@dataclasses.dataclass(frozen=True)
class Or(Predicate):
    terms: tuple

    def columns(self) -> frozenset:
        return frozenset().union(*(t.columns() for t in self.terms))

    def refutes(self, stats: "dict[str, ColStats]") -> bool:
        # every disjunct must be refuted to drop the group
        return all(t.refutes(stats) for t in self.terms)

    def mask(self, cols: "dict[str, np.ndarray]") -> np.ndarray:
        m = self.terms[0].mask(cols)
        for t in self.terms[1:]:
            m = np.logical_or(m, t.mask(cols))
        return m


class _ColBuilder:
    """``col("value") > 0`` sugar: comparison operators mint Cmp leaves."""

    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __lt__(self, v: Any) -> Cmp:
        return Cmp(self._name, "<", v)

    def __le__(self, v: Any) -> Cmp:
        return Cmp(self._name, "<=", v)

    def __gt__(self, v: Any) -> Cmp:
        return Cmp(self._name, ">", v)

    def __ge__(self, v: Any) -> Cmp:
        return Cmp(self._name, ">=", v)

    def __eq__(self, v: Any) -> Cmp:  # type: ignore[override]
        return Cmp(self._name, "==", v)

    def __ne__(self, v: Any) -> Cmp:  # type: ignore[override]
        return Cmp(self._name, "!=", v)

    def __hash__(self) -> int:  # __eq__ override kills the default
        return hash(self._name)


def col(name: str) -> _ColBuilder:
    return _ColBuilder(name)


def row_group_stats(shard, row_group: int,
                    columns: "Sequence[str]") -> "dict[str, ColStats]":
    """The predicate-relevant column statistics of one row group, pulled
    from the footer metadata the planner already holds (no extra I/O).
    Columns with absent/partial stats are simply missing from the dict —
    the refutation rule then conservatively passes them."""
    rg = shard.metadata.row_group(row_group)
    out: dict[str, ColStats] = {}
    for name in columns:
        ci = shard._col_index.get(name)
        if ci is None:
            continue
        st = rg.column(ci).statistics
        if st is None:
            continue
        mn = st.min if st.has_min_max else None
        mx = st.max if st.has_min_max else None
        nc = st.null_count if st.has_null_count else None
        out[name] = ColStats(mn, mx, nc)
    return out


# --- OpGraph: the fused per-sample operator chain ---------------------------

@dataclasses.dataclass(frozen=True)
class _Op:
    kind: str          # "filter" | "project" | "cast" | "normalize"
    fn: "Callable | None" = None
    index: "tuple | None" = None
    dtype: "np.dtype | None" = None
    mean: Any = None
    std: Any = None


class OpGraph:
    """A declarative per-sample operator chain; :meth:`compile` binds it to
    an input shape/dtype and returns the fused kernel."""

    def __init__(self) -> None:
        self._ops: list[_Op] = []

    def filter(self, fn: Callable[[np.ndarray], bool]) -> "OpGraph":
        """Per-sample predicate: a sample for which *fn* returns falsy is
        ZEROED (and counted), not dropped — static batch shapes and
        cross-process sharding survive."""
        self._ops.append(_Op("filter", fn=fn))
        return self

    def project(self, *index: "slice | int") -> "OpGraph":
        """Slice each sample (spatial crop / channel select): the index
        tuple is applied verbatim, e.g. ``project(slice(0, 64), slice(0, 64))``
        or ``project(Ellipsis, slice(0, 1))`` for channel 0."""
        self._ops.append(_Op("project", index=tuple(index)))
        return self

    def cast(self, dtype) -> "OpGraph":
        self._ops.append(_Op("cast", dtype=np.dtype(dtype)))
        return self

    def normalize(self, mean, std) -> "OpGraph":
        """(x - mean) / std in float32 (mean/std broadcast, e.g.
        per-channel)."""
        self._ops.append(
            _Op("normalize", mean=np.asarray(mean, dtype=np.float32),
                std=np.asarray(std, dtype=np.float32)))
        return self

    @property
    def ops(self) -> "tuple[_Op, ...]":
        return tuple(self._ops)

    def compile(self, in_shape: "tuple[int, ...]",
                in_dtype) -> "CompiledOpGraph":
        return CompiledOpGraph(self._ops, in_shape, np.dtype(in_dtype))


class CompiledOpGraph:
    """The chain bound to one sample shape/dtype: output geometry derived
    once by a dry run on a zero sample, then :meth:`apply_batch` applies the
    fused kernel per sample. Counter tallies accumulate under a lock
    (decode dispatch may apply the graph from more than one thread) and
    flush to the context's counters via :meth:`flush_stats`."""

    def __init__(self, ops: "Sequence[_Op]", in_shape: "tuple[int, ...]",
                 in_dtype: np.dtype):
        self.ops = tuple(ops)
        self.in_shape = tuple(in_shape)
        self.in_dtype = np.dtype(in_dtype)
        probe = self._apply_sample(
            np.zeros(self.in_shape, dtype=self.in_dtype), count=False)
        self.out_shape = probe.shape
        self.out_dtype = probe.dtype
        self._lock = make_lock("ops.graph")
        self._counts: dict[str, int] = {k: 0 for k in OPS_FIELDS}

    def _apply_sample(self, x: np.ndarray, *, count: bool = True
                      ) -> np.ndarray:
        dropped = 0
        for op in self.ops:
            if op.kind == "filter":
                if not op.fn(x):
                    x = np.zeros_like(x)
                    dropped += 1
            elif op.kind == "project":
                x = x[op.index]
            elif op.kind == "cast":
                x = x.astype(op.dtype)
            else:  # normalize
                x = (x.astype(np.float32) - op.mean) / op.std
        if count and dropped:
            with self._lock:
                self._counts["ops_filter_dropped"] += dropped
        return x

    def apply_batch(self, batch: np.ndarray,
                    out: "np.ndarray | None" = None) -> np.ndarray:
        """The fused kernel over a [N, ...] batch; deterministic per sample,
        so any partition of the batch (per-device-group fused dispatch vs
        one whole-batch call) produces bit-identical output. *out*: an
        array of ``(N,) + out_shape`` and ``out_dtype`` to write into (a
        pinned batch slot), else a new one."""
        n = len(batch)
        if out is None:
            out = np.empty((n,) + self.out_shape, dtype=self.out_dtype)
        for i in range(n):
            out[i] = self._apply_sample(batch[i])
        kinds = [op.kind for op in self.ops]
        with self._lock:
            self._counts["ops_graph_samples"] += n
            self._counts["ops_graph_runs"] += 1
            for kind in kinds:
                self._counts[f"ops_{kind}_samples"] += n
        return out

    def flush_stats(self, count: "Callable[..., None]") -> "dict[str, int]":
        """Move the accumulated tallies into ``count(**tallies)`` (the
        context's ``_count``); returns what was flushed (zero-delta names
        skipped)."""
        with self._lock:
            out = {k: v for k, v in self._counts.items() if v}
            for k in out:
                self._counts[k] = 0
        if out:
            count(**out)
        return out
