"""Counters, gauges and latency histograms with label scopes, and their
Prometheus text (the port's copy of ``strom/utils/stats.py``).

A :class:`StatsRegistry` holds named series; ``registry.scoped(tenant="t0")``
is a label-scoped child view whose writes land in BOTH the scoped series and
the registry's unlabelled aggregate, so the aggregate is always the sum of
its scopes. The scheduler writes its per-tenant counters through such
scopes, and the engine's per-op latency histogram goes through the scope of
the tenant that holds the grant.

:meth:`StatsRegistry.prometheus` renders a registry (its scopes as labelled
samples of the same families) and :func:`sections_prometheus` the nested
``StromContext.stats()`` sections, under the reference's series names and
``strom`` prefix, so a dashboard built on the reference reads the port.
"""

from __future__ import annotations

import threading
import weakref
from typing import Sequence

from strom_torch.utils.locks import make_lock


class _Counter:
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class _Gauge:
    """Last-set value (where a _Counter is a monotonic sum)."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def max(self, v: float) -> None:
        with self._lock:
            if v > self.value:
                self.value = v


class _Histogram:
    """Fixed-bucket latency histogram (microseconds, log2 buckets)."""

    N_BUCKETS = 24  # 1us .. ~8s

    __slots__ = ("buckets", "count", "total_us", "_lock")

    def __init__(self) -> None:
        self.buckets = [0] * self.N_BUCKETS
        self.count = 0
        self.total_us = 0.0
        self._lock = threading.Lock()

    def observe_us(self, us: float) -> None:
        # bucket i holds [2^i, 2^(i+1)), the native engine's convention
        b = max(0, min(self.N_BUCKETS - 1, int(us).bit_length() - 1))
        with self._lock:
            self.buckets[b] += 1
            self.count += 1
            self.total_us += us

    def add_buckets(self, buckets: Sequence[int], total_us: float) -> None:
        """Bulk-merge a log2 bucket delta of the same convention."""
        with self._lock:
            n = 0
            for i, b in enumerate(buckets[: self.N_BUCKETS]):
                self.buckets[i] += int(b)
                n += int(b)
            self.count += n
            self.total_us += total_us

    def percentile(self, q: float) -> float:
        """Approximate percentile in microseconds (upper bucket bound)."""
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            acc = 0
            for i, n in enumerate(self.buckets):
                acc += n
                if acc >= target:
                    return float(2 ** (i + 1))
            return float(2 ** self.N_BUCKETS)

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0


class _FanCounter:
    """A counter pair fanned by a scope: one add lands in the scoped series
    and in the aggregate."""

    __slots__ = ("_scoped", "_agg")

    def __init__(self, scoped: _Counter, agg: _Counter) -> None:
        self._scoped = scoped
        self._agg = agg

    def add(self, n: int = 1) -> None:
        self._scoped.add(n)
        self._agg.add(n)

    @property
    def value(self) -> int:
        return self._scoped.value


class _FanGauge:
    __slots__ = ("_scoped", "_agg")

    def __init__(self, scoped: _Gauge, agg: _Gauge) -> None:
        self._scoped = scoped
        self._agg = agg

    def set(self, v: float) -> None:
        self._scoped.set(v)
        self._agg.set(v)

    def max(self, v: float) -> None:
        self._scoped.max(v)
        self._agg.max(v)

    @property
    def value(self) -> float:
        return self._scoped.value


class _FanHistogram:
    __slots__ = ("_scoped", "_agg")

    def __init__(self, scoped: _Histogram, agg: _Histogram) -> None:
        self._scoped = scoped
        self._agg = agg

    def observe_us(self, us: float) -> None:
        self._scoped.observe_us(us)
        self._agg.observe_us(us)

    def add_buckets(self, buckets: Sequence[int], total_us: float) -> None:
        self._scoped.add_buckets(buckets, total_us)
        self._agg.add_buckets(buckets, total_us)

    def percentile(self, q: float) -> float:
        return self._scoped.percentile(q)

    @property
    def mean_us(self) -> float:
        return self._scoped.mean_us

    @property
    def count(self) -> int:
        return self._scoped.count

    @property
    def buckets(self) -> list[int]:
        return self._scoped.buckets

    @property
    def total_us(self) -> float:
        return self._scoped.total_us


def format_labels(labels: dict) -> str:
    """Canonical label body (sorted, escaped), the scope's identity string:
    ``pipeline="resnet",tenant="t0"``."""
    def esc(v: str) -> str:
        return str(v).replace("\\", r"\\").replace('"', r'\"') \
            .replace("\n", r"\n")

    return ",".join(f'{k}="{esc(v)}"' for k, v in sorted(labels.items()))


class ScopedStats:
    """Label-scoped child view of a :class:`StatsRegistry`: every write
    updates the scoped series and the parent's aggregate. Scopes with the
    same labels share one series store; :meth:`scoped` refines (labels
    merge, later keys win)."""

    __slots__ = ("parent", "labels", "_reg", "_fans")

    def __init__(self, parent: "StatsRegistry", labels: dict[str, str]):
        self.parent = parent
        self.labels = dict(labels)
        self._reg = parent._scope_registry(self.labels)
        # (kind, name) -> fan object, memoized: scoped writes sit on
        # per-completion paths (a rare duplicate build is harmless)
        self._fans: dict = {}

    def scoped(self, **labels) -> "ScopedStats":
        merged = dict(self.labels)
        merged.update({k: str(v) for k, v in labels.items() if v is not None})
        return self.parent.scoped(**merged)

    def counter(self, name: str) -> _FanCounter:
        fan = self._fans.get(("c", name))
        if fan is None:
            fan = self._fans[("c", name)] = _FanCounter(
                self._reg.counter(name), self.parent.counter(name))
        return fan

    def gauge(self, name: str) -> _FanGauge:
        fan = self._fans.get(("g", name))
        if fan is None:
            fan = self._fans[("g", name)] = _FanGauge(
                self._reg.gauge(name), self.parent.gauge(name))
        return fan

    def histogram(self, name: str) -> _FanHistogram:
        fan = self._fans.get(("h", name))
        if fan is None:
            fan = self._fans[("h", name)] = _FanHistogram(
                self._reg.histogram(name), self.parent.histogram(name))
        return fan

    def add(self, name: str, n: int = 1) -> None:
        self.counter(name).add(n)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    def observe_us(self, name: str, us: float) -> None:
        self.histogram(name).observe_us(us)

    def snapshot(self) -> dict:
        """The scoped series only (the aggregate lives on the parent)."""
        return self._reg.snapshot()


class StatsRegistry:
    """Named counters, gauges and histograms; one process-wide instance
    (:data:`global_stats`) and any number of private ones."""

    def __init__(self, name: str = "strom") -> None:
        self.name = name
        self._counters: dict[str, _Counter] = {}
        self._hists: dict[str, _Histogram] = {}
        self._gauges: dict[str, _Gauge] = {}
        self._lock = make_lock("stats.registry")
        # sorted label tuple -> the child registry holding that scope
        self._scopes: dict[tuple, "StatsRegistry"] = {}
        self.labels: dict[str, str] = {}
        with _registries_lock:
            _registries.add(self)

    def scoped(self, **labels) -> "ScopedStats | StatsRegistry":
        """A label-scoped child view (``scoped(pipeline="resnet",
        tenant="t0")``). No labels gives this registry itself, so callers
        can thread a scope unconditionally."""
        labels = {k: str(v) for k, v in labels.items() if v is not None}
        if not labels:
            return self
        return ScopedStats(self, labels)

    def _scope_registry(self, labels: dict[str, str]) -> "StatsRegistry":
        key = tuple(sorted(labels.items()))
        with self._lock:
            reg = self._scopes.get(key)
        if reg is not None:
            return reg
        # built outside self._lock: the constructor takes the registries
        # lock, which all_counter_names holds while it takes each
        # registry's
        fresh = StatsRegistry(self.name)
        fresh.labels = dict(labels)
        with self._lock:
            return self._scopes.setdefault(key, fresh)

    def scopes_snapshot(self) -> dict[str, dict]:
        """``{label string: snapshot}`` for every scope written through."""
        with self._lock:
            scopes = dict(self._scopes)
        return {format_labels(reg.labels): reg.snapshot()
                for reg in scopes.values()}

    def counter(self, name: str) -> _Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = _Counter()
            return c

    def gauge(self, name: str) -> _Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = _Gauge()
            return g

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    def histogram(self, name: str) -> _Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram()
            return h

    def add(self, name: str, n: int = 1) -> None:
        self.counter(name).add(n)

    def observe_us(self, name: str, us: float) -> None:
        self.histogram(name).observe_us(us)

    def snapshot(self) -> dict:
        out: dict = {}
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
            gauges = dict(self._gauges)
        for k, c in counters.items():
            out[k] = c.value
        for k, g in gauges.items():
            out[k] = g.value
        for k, h in hists.items():
            out[k + "_p50_us"] = h.percentile(0.50)
            out[k + "_p99_us"] = h.percentile(0.99)
            out[k + "_mean_us"] = h.mean_us
            out[k + "_total_us"] = h.total_us
            out[k + "_count"] = h.count
            out[k + "_hist"] = list(h.buckets)
        return out

    def counter_names(self) -> frozenset[str]:
        """Names registered as monotonic counters (the exposition types
        these ``counter``; every other number is a gauge)."""
        with self._lock:
            return frozenset(self._counters)

    def prometheus(self) -> str:
        """Prometheus text of every series. Scoped series render as
        labelled samples of the same families, under the unlabelled
        aggregate: one ``# HELP``/``# TYPE`` header a family covers both."""
        return _flat_prometheus(self.snapshot(), self.name,
                                counters=self.counter_names(),
                                scopes=self.scopes_snapshot())


def percentile_from_buckets(buckets: Sequence[int], q: float) -> float:
    """Approximate percentile (upper bucket bound, microseconds) of a log2
    bucket list: usable on the difference of two snapshots' buckets."""
    total = sum(buckets)
    if not total:
        return 0.0
    target = q * total
    acc = 0
    for i, n in enumerate(buckets):
        acc += n
        if acc >= target:
            return float(2 ** (i + 1))
    return float(2 ** len(buckets))


def _metric(*parts: str) -> str:
    return "_".join(parts).replace(".", "_").replace("-", "_")


def _hist_lines(base: str, buckets, sum_us: float, *, labels: str = "",
                header: bool = True) -> list[str]:
    """A cumulative Prometheus histogram from log2 microsecond buckets
    (bucket i = [2^i, 2^(i+1)) us). ``_count`` comes from the same bucket
    list, so ``+Inf`` always equals it; ``_sum`` is the exact total carried
    through the snapshot. *labels* (a label body) scopes every sample;
    *header* emits the family's ``# HELP``/``# TYPE``."""
    lines = []
    if header:
        lines += [
            f"# HELP {base}_us latency histogram (log2 microsecond buckets)",
            f"# TYPE {base}_us histogram"]
    extra = f",{labels}" if labels else ""
    acc = 0
    for i, n in enumerate(buckets):
        acc += int(n)
        lines.append(f'{base}_us_bucket{{le="{2 ** (i + 1)}"{extra}}} {acc}')
    lines.append(f'{base}_us_bucket{{le="+Inf"{extra}}} {acc}')
    brace = f"{{{labels}}}" if labels else ""
    lines.append(f"{base}_us_sum{brace} {sum_us}")
    lines.append(f"{base}_us_count{brace} {acc}")
    return lines


# the summary keys snapshot() derives from one histogram: folded into its
# histogram block, never series of their own
_HIST_SUMMARY_SUFFIXES = ("_total_us", "_mean_us", "_count",
                          "_p50_us", "_p99_us")


def _hist_stem(k: str, snap: dict) -> str | None:
    """The histogram stem when *k* is a summary key of a histogram present
    in *snap* (``read_latency_total_us`` beside ``read_latency_hist``)."""
    for suf in _HIST_SUMMARY_SUFFIXES:
        if k.endswith(suf) and (k[: -len(suf)] + "_hist") in snap:
            return k[: -len(suf)]
    return None


def _flat_prometheus(snap: dict, prefix: str,
                     counters: "frozenset[str] | set[str] | None" = None,
                     scopes: "dict[str, dict] | None" = None) -> str:
    """``*_hist`` bucket lists become histograms (``_sum`` from their
    ``*_total_us`` sibling, ``_count`` from the buckets); names in
    *counters* are typed ``counter``, every other number ``gauge``; a
    histogram's summary keys fold into its block; non-numeric leaves are
    skipped. *scopes* (``{label string: scope snapshot}``) adds a labelled
    sample under each family's unlabelled one."""
    counters = counters or frozenset()
    scopes = scopes or {}
    lines: list[str] = []
    for k, v in sorted(snap.items()):
        if k.endswith("_hist") and isinstance(v, (list, tuple)):
            stem = k[: -len("_hist")]
            total = snap.get(stem + "_total_us")
            if total is None:
                total = float(snap.get(stem + "_mean_us", 0.0)) \
                    * int(snap.get(stem + "_count", sum(int(n) for n in v)))
            base = _metric(prefix, stem)
            lines.extend(_hist_lines(base, v, float(total)))
            for lbl, ssnap in sorted(scopes.items()):
                sv = ssnap.get(k)
                if not isinstance(sv, (list, tuple)):
                    continue
                stotal = float(ssnap.get(stem + "_total_us", 0.0))
                lines.extend(_hist_lines(base, sv, stotal, labels=lbl,
                                         header=False))
        elif _hist_stem(k, snap) is not None:
            continue
        elif isinstance(v, bool):
            m = _metric(prefix, k)
            lines.append(f"# HELP {m} strom stat {k}")
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {int(v)}")
        elif isinstance(v, (int, float)):
            m = _metric(prefix, k)
            typ = "counter" if k in counters else "gauge"
            lines.append(f"# HELP {m} strom stat {k}")
            lines.append(f"# TYPE {m} {typ}")
            lines.append(f"{m} {v}")
            for lbl, ssnap in sorted(scopes.items()):
                sv = ssnap.get(k)
                if isinstance(sv, bool):
                    lines.append(f"{m}{{{lbl}}} {int(sv)}")
                elif isinstance(sv, (int, float)):
                    lines.append(f"{m}{{{lbl}}} {sv}")
    return "\n".join(lines) + "\n"


def all_counter_names() -> frozenset[str]:
    """Counter names across every live registry (the process-wide one,
    the scopes, each prefetcher's): how the sections exposition, which
    sees plain dicts, types a key ``counter``. The weak set is copied under
    its lock, so a registry built during a scrape cannot resize it
    mid-iteration."""
    with _registries_lock:
        regs = list(_registries)
    names: set[str] = set()
    for reg in regs:
        names.update(reg.counter_names())
    return frozenset(names)


def sections_prometheus(sections: dict, prefix: str = "strom",
                        counters: "frozenset[str] | None" = None) -> str:
    """Prometheus text of a nested stats dict (``{section: {key: value}}``,
    the shape ``StromContext.stats()`` returns), each section under
    ``<prefix>_<section>``. A section that is not a dict is skipped; a key
    that names a registered counter is typed ``counter``."""
    counters = all_counter_names() if counters is None else counters
    return "".join(
        _flat_prometheus(vals, f"{prefix}_{sec}", counters=counters)
        for sec, vals in sections.items() if isinstance(vals, dict))


# live registries, for all_counter_names(); weak, so a short-lived
# registry (a prefetcher's) does not pile up. Adds and the copy taken for
# iteration hold the lock
_registries: "weakref.WeakSet[StatsRegistry]" = weakref.WeakSet()
_registries_lock = make_lock("stats.registries")

global_stats = StatsRegistry("strom")
