"""WebDataset ``.tar`` shards: index once, then range-read members (the
port's copy of ``strom/formats/wds.py``).

Only the tar headers are read at index time (cached in a sidecar); payload
bytes flow through the engine as plain byte ranges, so member reads get
O_DIRECT and RAID0 striping like any other gather. Consumer: the vision
pipelines.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import tarfile
from typing import Any, Iterator, Mapping, Sequence

from strom_torch.delivery.core import SourceIO
from strom_torch.delivery.extents import Extent, ExtentList

_IDX_SUFFIX = ".stromidx.json"
_IDX_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TarMember:
    name: str
    offset: int    # byte offset of the member's *data* (past the 512B header)
    size: int


@dataclasses.dataclass(frozen=True)
class WdsSample:
    """One WebDataset sample: every member sharing a basename key."""

    key: str
    shard: str                         # tar path
    members: Mapping[str, TarMember]   # extension -> member

    def extents(self, exts: Sequence[str] | None = None) -> ExtentList:
        """Gather plan for this sample's payload bytes, members concatenated
        in the given extension order (default: sorted)."""
        order = list(exts) if exts is not None else sorted(self.members)
        ext_list = []
        for e in order:
            m = self.members[e]
            if m.size > 0:
                ext_list.append(Extent(self.shard, m.offset, m.size))
        return ExtentList(ext_list)


def split_key(name: str) -> tuple[str, str]:
    """WebDataset naming: key = name up to the first '.' of the basename,
    extension = the rest ('a/b.cls.txt' → ('a/b', 'cls.txt'))."""
    dirname, _, base = name.rpartition("/")
    stem, _, ext = base.partition(".")
    key = f"{dirname}/{stem}" if dirname else stem
    return key, ext


class TarIndex:
    """Member table of one tar shard, built once and cached in a sidecar."""

    def __init__(self, path: str, members: list[TarMember]):
        self.path = path
        self.members = members

    @classmethod
    def build(cls, path: str, *, cache: bool = True,
              fileobj: io.RawIOBase | None = None) -> "TarIndex":
        """Index the shard at *path*. With *fileobj* (a :class:`SourceIO`
        over a striped set aliased to *path*, say) the headers are read
        through it and the sidecar is skipped: the path need not exist."""
        if fileobj is not None:
            cache = False
        cached = cls._load_cache(path) if cache else None
        if cached is not None:
            return cached
        members: list[TarMember] = []
        # tarfile seeks header to header and never reads payloads
        with tarfile.open(path, "r:", fileobj=fileobj) as tf:
            for m in tf:
                if m.isfile():
                    members.append(TarMember(m.name, m.offset_data, m.size))
        idx = cls(path, members)
        if cache:
            idx._save_cache()
        return idx

    # -- sidecar cache ------------------------------------------------------
    def _cache_path(self) -> str:
        return self.path + _IDX_SUFFIX

    def _save_cache(self) -> None:
        st = os.stat(self.path)
        blob = {
            "version": _IDX_VERSION,
            "tar_size": st.st_size,
            "tar_mtime_ns": st.st_mtime_ns,
            "members": [[m.name, m.offset, m.size] for m in self.members],
        }
        tmp = self._cache_path() + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(blob, f)
            os.replace(tmp, self._cache_path())
        except OSError:
            pass  # read-only dataset dir: the index stays in memory only

    @classmethod
    def _load_cache(cls, path: str) -> "TarIndex | None":
        try:
            with open(path + _IDX_SUFFIX) as f:
                blob = json.load(f)
            st = os.stat(path)
            if (blob.get("version") != _IDX_VERSION
                    or blob.get("tar_size") != st.st_size
                    or blob.get("tar_mtime_ns") != st.st_mtime_ns):
                return None
            return cls(path, [TarMember(n, o, s) for n, o, s in blob["members"]])
        except (OSError, ValueError, KeyError):
            return None

    # -- sample grouping ----------------------------------------------------
    def samples(self) -> list[WdsSample]:
        """Group members into WebDataset samples, preserving shard order."""
        grouped: dict[str, dict[str, TarMember]] = {}
        order: list[str] = []
        for m in self.members:
            key, ext = split_key(m.name)
            if key not in grouped:
                grouped[key] = {}
                order.append(key)
            grouped[key][ext] = m
        return [WdsSample(k, self.path, grouped[k]) for k in order]


class WdsShardSet:
    """Multiple tar shards addressed as one sample collection."""

    def __init__(self, paths: Sequence[str], *, cache_index: bool = True,
                 ctx: Any = None):
        """*ctx*: a StromContext; shard paths it aliases to striped sets
        are indexed through the engine instead of the (absent) plain path.
        The samples' extents keep the aliased path, so payload gathers
        stripe-decode in the delivery layer."""
        if not paths:
            raise ValueError("need at least one shard")
        self.paths = tuple(paths)
        self.indexes = []
        for p in self.paths:
            sf = ctx.striped_source(p) if ctx is not None else None
            self.indexes.append(
                TarIndex.build(p, cache=cache_index,
                               fileobj=SourceIO(ctx, sf) if sf is not None
                               else None))
        self._samples: list[WdsSample] = []
        for idx in self.indexes:
            self._samples.extend(idx.samples())

    @property
    def samples(self) -> list[WdsSample]:
        return self._samples

    def __len__(self) -> int:
        return len(self._samples)

    def __iter__(self) -> Iterator[WdsSample]:
        return iter(self._samples)

    def batch_extents(self, sample_indices: Sequence[int],
                      exts: Sequence[str] | None = None) -> ExtentList:
        """One gather plan covering a whole batch of samples."""
        return ExtentList.concat(
            [self._samples[i].extents(exts) for i in sample_indices])
