"""ExtentList: a logical byte stream gather-composed from file ranges.

nvme-strom's MEMCPY_SSD2GPU ioctl takes a *chunk list*: a vector of file
ranges DMA'd into one destination buffer. ExtentList is its counterpart
(the port's copy of ``strom/delivery/extents.py``): a format reader (here
the packed-token records) compiles its record layout into an ExtentList,
and the delivery layer treats it as a virtual contiguous file.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import Iterator, Sequence


@dataclasses.dataclass(frozen=True)
class Extent:
    """One physical file range contributing to the logical stream."""

    path: str
    offset: int
    length: int

    def __post_init__(self) -> None:
        if self.length <= 0:
            raise ValueError(f"extent length must be positive, got {self.length}")
        if self.offset < 0:
            raise ValueError(f"extent offset must be >= 0, got {self.offset}")


@dataclasses.dataclass(frozen=True)
class PhysicalRun:
    """A physical read serving part of a logical range."""

    path: str
    offset: int        # physical byte offset in path
    length: int
    dest_offset: int   # where in the caller's destination this run lands


class ExtentList:
    """Immutable ordered list of extents forming one logical byte stream.

    Logical offset 0 is the first byte of extents[0]; extents concatenate.
    """

    __slots__ = ("extents", "_starts", "size")

    def __init__(self, extents: Sequence[Extent | tuple]):
        ext = tuple(e if isinstance(e, Extent) else Extent(*e) for e in extents)
        self.extents: tuple[Extent, ...] = ext  # may be empty: a 0-byte stream
        # prefix sums: _starts[i] = logical offset of extents[i]
        starts = list(itertools.accumulate((e.length for e in ext), initial=0))
        self.size: int = starts.pop()
        self._starts: list[int] = starts

    def __len__(self) -> int:
        return len(self.extents)

    def __repr__(self) -> str:
        return f"ExtentList({len(self.extents)} extents, {self.size} bytes)"

    def locate(self, logical_offset: int, length: int,
               dest_offset: int = 0) -> Iterator[PhysicalRun]:
        """Map logical [logical_offset, +length) to physical runs.

        Runs are emitted in logical order; dest offsets advance from
        *dest_offset* so they can be fed straight into a gather read.
        """
        if logical_offset < 0 or length < 0:
            raise ValueError("offset/length must be >= 0")
        if logical_offset + length > self.size:
            raise ValueError(
                f"range [{logical_offset}, +{length}) beyond stream size {self.size}")
        remaining = length
        pos = logical_offset
        dest = dest_offset
        # index of the extent containing `pos`
        i = bisect.bisect_right(self._starts, pos) - 1
        while remaining > 0:
            e = self.extents[i]
            within = pos - self._starts[i]
            take = min(e.length - within, remaining)
            yield PhysicalRun(e.path, e.offset + within, take, dest)
            pos += take
            dest += take
            remaining -= take
            i += 1
        return

    def slice(self, logical_offset: int, length: int) -> "ExtentList":
        """A new ExtentList viewing logical [logical_offset, +length)."""
        runs = list(self.locate(logical_offset, length))
        return ExtentList([Extent(r.path, r.offset, r.length) for r in runs])

    def paths(self) -> tuple[str, ...]:
        """Distinct backing paths, in first-appearance order."""
        seen: dict[str, None] = {}
        for e in self.extents:
            seen.setdefault(e.path)
        return tuple(seen)

    @staticmethod
    def concat(parts: Sequence["ExtentList"]) -> "ExtentList":
        out: list[Extent] = []
        for p in parts:
            out.extend(p.extents)
        return ExtentList(out)
