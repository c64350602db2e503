"""Software RAID0 stripe math (the port's copy of ``strom/engine/raid0.py``).

The reference decodes md-raid0 striping *in the kernel* so each NVMe READ
lands on the right member device. strom does the same arithmetic in
userspace: a logical byte range over an N-member stripe becomes per-member
(offset, length) segments, which the engine reads concurrently — the same
math the kernel's raid0 map performs, applied to member files or devices
opened directly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class StripeSegment:
    member: int        # member index [0, n)
    member_offset: int # byte offset within the member
    logical_offset: int  # byte offset within the logical (striped) address space
    length: int


def plan_stripe_reads(offset: int, length: int, n_members: int, chunk: int) -> list[StripeSegment]:
    """Map logical [offset, offset+length) over an n-member RAID0 with the given
    chunk size into per-member segments, ordered by logical offset.

    Layout (classic md-raid0): logical chunk k lives on member (k % n) at
    member-chunk index (k // n).
    """
    if n_members <= 0:
        raise ValueError("n_members must be positive")
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    if offset < 0 or length < 0:
        raise ValueError("offset/length must be non-negative")
    segs: list[StripeSegment] = []
    pos = offset
    end = offset + length
    while pos < end:
        chunk_idx = pos // chunk
        within = pos % chunk
        take = min(chunk - within, end - pos)
        member = chunk_idx % n_members
        member_off = (chunk_idx // n_members) * chunk + within
        segs.append(StripeSegment(member, member_off, pos, take))
        pos += take
    return segs


def coalesce(segs: list[StripeSegment]) -> list[StripeSegment]:
    """Merge adjacent segments on the same member that are contiguous in both
    member and logical space (happens when chunk > block size)."""
    out: list[StripeSegment] = []
    for s in segs:
        if out:
            p = out[-1]
            if (p.member == s.member
                    and p.member_offset + p.length == s.member_offset
                    and p.logical_offset + p.length == s.logical_offset):
                out[-1] = StripeSegment(p.member, p.member_offset, p.logical_offset, p.length + s.length)
                continue
        out.append(s)
    return out


def plan_stripe_windows(segs: Sequence[StripeSegment], n_members: int,
                        window_bytes: int) -> list[StripeSegment]:
    """Reorder logical-order stripe segments into overlap windows: within
    each window of ~*window_bytes* total, segments are grouped into
    per-member runs (member-offset order preserved, so each run is a
    sequential read on its member).

    The engine keeps its queue-depth pipeline full ACROSS the list, so a
    window sized to the in-flight budget (queue_depth × block_size) means
    member ops for window N+1 are entering the submission queue while window
    N's completions drain — continuous per-member streams instead of a
    chunk-granular round-robin hopping files every raid_chunk bytes. Every
    byte mapping is unchanged (dest offsets are explicit); only submission
    order moves. window_bytes <= 0 keeps logical order. Consecutive windows
    continue each member's run at the exact next member offset, so
    downstream run detection (the native engine's residency-probe
    coalescing) still sees long member-contiguous streaks."""
    if window_bytes <= 0 or n_members <= 1:
        return list(segs)
    out: list[StripeSegment] = []
    win: list[StripeSegment] = []
    acc = 0

    def flush() -> None:
        by_member: dict[int, list[StripeSegment]] = {}
        for s in win:
            by_member.setdefault(s.member, []).append(s)
        for m in sorted(by_member):
            out.extend(by_member[m])

    for s in segs:
        win.append(s)
        acc += s.length
        if acc >= window_bytes:
            flush()
            win = []
            acc = 0
    if win:
        flush()
    return out


def count_stripe_windows(segs: Sequence[StripeSegment], n_members: int,
                         window_bytes: int) -> int:
    """Exactly how many windows :func:`plan_stripe_windows` flushes for the
    same inputs (same accumulation rule: a flush can consume MORE than
    window_bytes when segment lengths don't divide it, so ceil(total/wb)
    would overcount) — kept adjacent so the two can't drift."""
    if window_bytes <= 0 or n_members <= 1:
        return 0
    windows = 0
    acc = 0
    for s in segs:
        acc += s.length
        if acc >= window_bytes:
            windows += 1
            acc = 0
    return windows + (1 if acc else 0)


SIZE_SIDECAR_SUFFIX = ".stromsz"


def stripe_file(src: str, members: Sequence[str], chunk: int) -> int:
    """Write *src*'s bytes into RAID0 member files (logical chunk k → member
    k % n at member-chunk k // n), zero-padding the tail to a full stripe
    width so the striped logical size covers the whole source. Fixture/bench
    helper: the inverse of what :func:`plan_stripe_reads` decodes.

    Returns the TRUE source size, and records it in a ``.stromsz`` sidecar
    next to the first member: without it, ``StripedFile.size`` reports the
    zero-padded stripe width, and formats that trust the size — trailing
    parquet footers, rawbin record counting — silently read the padding as
    data. Members are written to temp names and renamed only on completion,
    so an interrupted stripe can never be mistaken for a finished one.
    """
    n = len(members)
    if n <= 0 or chunk <= 0:
        raise ValueError("need >= 1 member and a positive chunk")
    size = os.stat(src).st_size
    width = chunk * n
    padded = -(-size // width) * width
    tmps = [m + ".tmp" for m in members] \
        + [members[0] + SIZE_SIDECAR_SUFFIX + ".tmp"]
    outs = [open(t, "wb") for t in tmps[:-1]]
    try:
        try:
            with open(src, "rb") as f:
                for pos in range(0, padded, chunk):
                    data = f.read(chunk)
                    if len(data) < chunk:
                        data = data.ljust(chunk, b"\0")
                    outs[(pos // chunk) % n].write(data)
        finally:
            for o in outs:
                o.close()
        with open(tmps[-1], "w") as f:
            f.write(str(size))
        for m in members:
            os.replace(m + ".tmp", m)
        os.replace(tmps[-1], members[0] + SIZE_SIDECAR_SUFFIX)
    except BaseException:
        # a failed stripe (ENOSPC mid-write) must not leave GiB-scale .tmp
        # garbage next to the dataset
        for t in tmps:
            try:
                os.unlink(t)
            except OSError:
                pass
        raise
    return size


def logical_size(member_sizes: list[int], chunk: int) -> int:
    """Usable striped capacity given member sizes (md-raid0 uses min size × n for
    equal members; we require the common prefix that stripes evenly)."""
    if not member_sizes:
        return 0
    usable = min(member_sizes)
    full_chunks = usable // chunk
    return full_chunks * chunk * len(member_sizes)
