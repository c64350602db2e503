"""Segment/op coalescing for the delivery layer (the port's copy of
``strom/delivery/coalesce.py``).

Format readers hand the delivery layer fine-grained segment lists (one per
record run), and many of those are adjacent on disk and in the destination
(sorted batch indices over a packed shard). Submitting them as they are
costs one engine op per fragment, plus an unaligned tail per fragment on
the O_DIRECT path. Coalescing merges runs that are contiguous in both file
and dest space into fewer, larger ops before submission. A split threshold
caps the merged op length, so a coalesced run still pipelines instead of
becoming one monolithic op.
"""

from __future__ import annotations

from typing import Sequence

from strom_torch.delivery.shard import Segment

# an engine gather op: (file_idx, file_offset, dest_offset, length)
Chunk = tuple[int, int, int, int]


def _merge_runs(runs: list[tuple[int, int, int]],
                max_bytes: int) -> list[tuple[int, int, int]]:
    """Merge (file_off, dest_off, length) runs that share one file/dest
    delta: input sorted by file_off, overlap/adjacency merges to the union,
    then each merged run splits at *max_bytes* (0 = no split)."""
    merged: list[list[int]] = []
    for fo, do, ln in runs:
        if merged:
            p = merged[-1]
            if fo <= p[0] + p[2]:  # adjacent or overlapping (same delta)
                p[2] = max(p[2], fo + ln - p[0])
                continue
        merged.append([fo, do, ln])
    if max_bytes <= 0:
        return [(fo, do, ln) for fo, do, ln in merged]
    out: list[tuple[int, int, int]] = []
    for fo, do, ln in merged:
        pos = 0
        while ln - pos > max_bytes:
            out.append((fo + pos, do + pos, max_bytes))
            pos += max_bytes
        out.append((fo + pos, do + pos, ln - pos))
    return out


def coalesce_segments(segments: Sequence[Segment],
                      max_bytes: int = 0) -> list[Segment]:
    """Merge segments that are contiguous (or overlapping) in both file and
    dest space; split merged runs longer than *max_bytes* (0 = unlimited).

    Segments with the same file↔dest delta whose ranges touch describe one
    larger copy; overlapping same-delta ranges are deduplicated to the union
    (same bytes land in the same place either way). Segments with different
    deltas never merge — they move different dest bytes. Output is sorted by
    dest offset (the order :func:`split_segments` normalizes to anyway).
    """
    groups: dict[int, list[tuple[int, int, int]]] = {}
    for s in segments:
        groups.setdefault(s.file_offset - s.dest_offset, []).append(
            (s.file_offset, s.dest_offset, s.length))
    out: list[Segment] = []
    for runs in groups.values():
        runs.sort()
        out.extend(Segment(fo, do, ln)
                   for fo, do, ln in _merge_runs(runs, max_bytes))
    out.sort(key=lambda s: s.dest_offset)
    return out


def coalesce_chunks(chunks: Sequence[Chunk], max_bytes: int = 0) -> list[Chunk]:
    """:func:`coalesce_segments` for engine op lists: merge ops on the same
    file that are contiguous/overlapping in both file and dest space, split
    at *max_bytes*. Ops on different files (several shards of one
    ExtentList) never merge. Output order: grouped by file in first-appearance
    order, dest-sorted within a file — any order is valid for the engine
    (dest offsets are explicit); this one preserves the input's file
    locality."""
    # file -> delta -> runs: insertion-ordered dicts give first-appearance
    # file order and one linear pass over each file's own delta groups
    by_file: dict[int, dict[int, list[tuple[int, int, int]]]] = {}
    for fi, fo, do, ln in chunks:
        by_file.setdefault(fi, {}).setdefault(fo - do, []).append(
            (fo, do, ln))
    out: list[Chunk] = []
    for fi, groups in by_file.items():
        per_file: list[tuple[int, int, int]] = []
        for runs in groups.values():
            runs.sort()
            per_file.extend(_merge_runs(runs, max_bytes))
        per_file.sort(key=lambda r: r[1])  # dest order within the file
        out.extend((fi, fo, do, ln) for fo, do, ln in per_file)
    return out
