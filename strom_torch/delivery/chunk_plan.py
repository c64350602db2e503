"""Extent-aware gather planning: make the FIEMAP map load-bearing (the
port's copy of ``strom/delivery/chunk_plan.py``).

nvme-strom resolves file offset → device LBA in the kernel and builds NVMe
requests in physical terms. A userspace engine submits in (fd, logical
offset) terms, but the physical map still buys something on fragmented
files: splitting gather chunks at extent boundaries and issuing them in
PHYSICAL-address order turns a logically-sequential read of a fragmented
file — which the device sees as random LBA hops — into a near-sequential
LBA stream. On a contiguous file (the common case) the plan is
byte-identical to the naive one and costs one cached FIEMAP per file.
"""

from __future__ import annotations

import bisect
from typing import Sequence

from strom_torch.probe.fiemap import Extent

# an engine gather chunk: (file_idx, file_offset, dest_offset, length)
Chunk = tuple[int, int, int, int]


def plan_chunks_multi(chunks: Sequence[Chunk],
                      extent_maps: dict[int, Sequence[Extent]]) -> list[Chunk]:
    """Extent-aware planning over a gather spanning several files (format
    readers' ExtentLists, striped members): chunks group by file — stable in
    first-appearance order, so a per-sample interleaving becomes per-file
    runs — and each group is planned against its file's FIEMAP map when one
    is available. Any submission order is valid (dest offsets are explicit);
    only locality changes."""
    groups: dict[int, list[Chunk]] = {}  # insertion-ordered
    for c in chunks:
        groups.setdefault(c[0], []).append(c)
    out: list[Chunk] = []
    for fi, g in groups.items():
        em = extent_maps.get(fi)
        out.extend(plan_chunks(g, em) if em else g)
    return out


def plan_chunks(chunks: Sequence[Chunk], extents: Sequence[Extent]
                ) -> list[Chunk]:
    """Split *chunks* (all for one file, mapped by *extents*) at extent
    boundaries and order them by physical address.

    Correctness invariant (property-tested): the output covers exactly the
    same file_offset→dest_offset byte mapping as the input — only the split
    points and submission order change, and the engine's vectored gather
    carries explicit dest offsets, so any order is valid.

    Bytes not covered by a reliable extent (holes, delalloc, unknown) keep
    logical order after all physically-mapped bytes.
    """
    ext = [e for e in extents if e.is_reliable and e.length > 0]
    if len(ext) <= 1:
        return list(chunks)
    ext.sort(key=lambda e: e.logical)
    starts = [e.logical for e in ext]

    # (physical_or_None, file_idx, file_off, dest_off, len)
    tagged: list[tuple[int | None, int, int, int, int]] = []
    for fi, off, doff, ln in chunks:
        pos, end = off, off + ln
        while pos < end:
            i = bisect.bisect_right(starts, pos) - 1
            phys: int | None = None
            if i >= 0 and pos < ext[i].logical + ext[i].length:
                e = ext[i]
                seg_end = min(end, e.logical + e.length)
                phys = e.physical + (pos - e.logical)
            elif i + 1 < len(starts):
                seg_end = min(end, starts[i + 1])  # gap before next extent
            else:
                seg_end = end                      # past the last extent
            tagged.append((phys, fi, pos, doff + (pos - off), seg_end - pos))
            pos = seg_end

    tagged.sort(key=lambda t: (t[0] is None,
                               t[0] if t[0] is not None else t[2]))

    # merge neighbors that are contiguous in file, dest AND physical terms —
    # re-joins the splits inside one extent run so chunk count only grows
    # where the file is actually fragmented
    out: list[tuple[int | None, int, int, int, int]] = []
    for phys, fi, off, doff, ln in tagged:
        if out:
            p0, f0, o0, d0, l0 = out[-1]
            if (f0 == fi and o0 + l0 == off and d0 + l0 == doff
                    and p0 is not None and phys is not None
                    and p0 + l0 == phys):
                out[-1] = (p0, f0, o0, d0, l0 + ln)
                continue
        out.append((phys, fi, off, doff, ln))
    return [(fi, off, doff, ln) for (_, fi, off, doff, ln) in out]
