"""Multi-process work assignment (the port's copy of
``assign_balanced`` from ``strom/parallel/multihost.py``; the rest of that
module, its barriers and straggler accounting over a process group, waits
for ROADMAP Queue A item 8)."""

from __future__ import annotations

from typing import Sequence


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
