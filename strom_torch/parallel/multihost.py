"""Multi-process coordination: epoch barriers, straggler accounting,
balanced work assignment (the port's counterpart of
``strom/parallel/multihost.py``).

Cross-process traffic rides ``torch.distributed``'s gloo groups of
:mod:`strom_torch.parallel.mesh` (the reference rides jax's distributed
runtime): host values, never device tensors. Without a process group
every call is the single-process answer.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Sequence

from strom_torch.parallel import mesh as _mesh


def process_count() -> int:
    return _mesh.world_size()


def epoch_barrier(name: str) -> None:
    """Block until every process reaches this point: a barrier on the
    epoch group (gloo). No-op in single-process runs; *name* says which
    boundary it is in a trace (e.g. f"epoch-{n}")."""
    if process_count() <= 1:
        return
    import torch.distributed as dist

    from strom_torch.obs import request as _request

    with _request.span("multihost.epoch_barrier", cat="sync",
                       args={"name": name}):
        dist.barrier(group=_mesh.epoch_group())


def assign_balanced(sizes: Sequence[int], n_bins: int) -> list[list[int]]:
    """Greedy LPT (longest-processing-time-first) assignment of work units to
    bins: sort by size descending, place each in the currently-lightest bin.

    Deterministic in (sizes, n_bins) — every process computes the same
    assignment with no coordination, same as the samplers. Replaces
    round-robin for the Parquet fan-out, where skewed row-group sizes make
    the heaviest host the critical path (VERDICT.md missing #4); LPT is
    within 4/3 of optimal makespan.

    Returns n_bins lists of unit indices; each list preserves ascending index
    order (deterministic iteration within a host).
    """
    import heapq

    if n_bins <= 0:
        raise ValueError("n_bins must be positive")
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    bins: list[list[int]] = [[] for _ in range(n_bins)]
    # (load, bin) heap: O(n log b) instead of the naive O(n*b) lightest-bin
    # scan — at pod shape (256 bins, 10k+ units, VERDICT.md r3 next #5) the
    # naive scan is ~2.6M comparisons on the coordinator-free hot path every
    # process runs at every scan. Tie-break on bin index, identical to the
    # sequential scan's ordering, so assignments are unchanged.
    heap = [(0, j) for j in range(n_bins)]  # already a valid heap
    for i in order:
        load, b = heapq.heappop(heap)
        bins[b].append(i)
        heapq.heappush(heap, (load + sizes[i], b))
    for b in bins:
        b.sort()
    return bins


@dataclasses.dataclass(frozen=True)
class HostStepStats:
    process_index: int
    steps: int
    mean_s: float
    p99_s: float


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    hosts: tuple[HostStepStats, ...]
    median_mean_s: float
    stragglers: tuple[int, ...]  # process indices slower than threshold×median

    def __str__(self) -> str:
        rows = ", ".join(f"p{h.process_index}: {h.mean_s * 1e3:.1f}ms"
                         f"(p99 {h.p99_s * 1e3:.1f})" for h in self.hosts)
        tail = f"; stragglers: {list(self.stragglers)}" if self.stragglers else ""
        return f"steps [{rows}]{tail}"


class StragglerMonitor:
    """Per-process step-time skew accounting.

    Each process records its own step durations (`record`, or wrap the
    loop body with `step()`); `report()` all-gathers (steps, mean, p99)
    over the host group and flags processes whose mean exceeds threshold×
    the median: the sign that one process's I/O (or its data shard) is the
    job's critical path.
    """

    def __init__(self, window: int = 256):
        self._times: deque[float] = deque(maxlen=window)
        self._t0: float | None = None

    # -- recording ----------------------------------------------------------
    def record(self, seconds: float) -> None:
        self._times.append(seconds)

    def step(self) -> "StragglerMonitor":
        return self  # context-manager form: with monitor.step(): <step body>

    def __enter__(self) -> "StragglerMonitor":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is not None:
            self.record(time.monotonic() - self._t0)
            self._t0 = None

    # -- local stats --------------------------------------------------------
    def local_stats(self) -> tuple[int, float, float]:
        """(steps, mean_s, p99_s) of the recorded window."""
        if not self._times:
            return 0, 0.0, 0.0
        ts = sorted(self._times)
        mean = sum(ts) / len(ts)
        p99 = ts[min(len(ts) - 1, int(0.99 * len(ts)))]
        return len(ts), mean, p99

    # -- cross-process report -----------------------------------------------
    def report(self, threshold: float = 1.25) -> StragglerReport:
        """Every process's stats (a collective: every process must call)."""
        import torch

        steps, mean, p99 = self.local_stats()
        local = torch.tensor([float(steps), mean, p99], dtype=torch.float64)
        if process_count() > 1:
            import torch.distributed as dist

            rows = [torch.empty_like(local) for _ in range(process_count())]
            dist.all_gather(rows, local, group=_mesh.host_group())
        else:
            rows = [local]
        hosts = tuple(HostStepStats(i, int(r[0]), float(r[1]), float(r[2]))
                      for i, r in enumerate(rows))
        means = sorted(h.mean_s for h in hosts)
        median = means[len(means) // 2]
        stragglers = tuple(h.process_index for h in hosts
                           if median > 0 and h.mean_s > threshold * median)
        return StragglerReport(hosts, median, stragglers)
