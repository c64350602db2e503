"""Parquet columnar reads (the port's counterpart of
``strom/formats/parquet.py``): column-chunk byte ranges through the engine,
decoded on the host.

The footer is read by the port's own Thrift decoder
(:mod:`strom_torch.formats.parquet_thrift`), so opening a shard, planning
its chunk gathers and decoding uncompressed PLAIN chunks need no pyarrow.
Such a chunk's bytes are its values after small page headers and an
all-present definition-level run, so decode is ``np.frombuffer`` over the
engine's slab: zero copies. Any chunk the fast path cannot prove safe
(compression, dictionary pages, nulls, logical types that are not the
physical meaning, v2 pages, other encodings) routes the row group through
pyarrow, which is imported only there and raises a clear ``RuntimeError``
where it is absent. :func:`write_parquet` writes PLAIN files natively.

Consumer: the Parquet scan pipeline (BASELINE config #5).
"""

from __future__ import annotations

import bisect
import os
from typing import TYPE_CHECKING, Sequence

import numpy as np

from strom_torch.delivery.buffers import alloc_aligned
from strom_torch.delivery.core import source_size
from strom_torch.delivery.extents import Extent, ExtentList
from strom_torch.formats.rawbin import truncate_to
from strom_torch.formats.parquet_thrift import (_thrift_struct, _uvarint,
                                                encode_data_page_header,
                                                encode_file_metadata,
                                                encode_statistics,
                                                read_file_metadata)
from strom_torch.utils.locks import make_lock

if TYPE_CHECKING:
    import pyarrow as pa

    from strom_torch.delivery.core import StromContext


def _pyarrow_parquet(what: str):
    """``pyarrow.parquet``, imported where a route needs it. A capability
    probe, as for cv2 (``strom_torch/formats/jpeg.py``): pyarrow can fail
    with other errors than ImportError; absent, *what* raises a
    RuntimeError that says so."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except Exception as e:
        raise RuntimeError(f"{what} needs pyarrow, which does not import "
                           f"here ({e!r})") from e
    _malloc_pool(pa)
    return pq


_pool_chosen = False


def _malloc_pool(pa) -> None:
    """Make malloc pyarrow's default pool, once, unless the user chose one
    (``ARROW_DEFAULT_MEMORY_POOL``), whoever loaded pyarrow first: its
    bundled mimalloc pool, in a process that loaded torch, crashed it
    (SIGSEGV in ``read_row_group`` on the scan's prefetch threads) within
    ten scans; the system pool did not."""
    global _pool_chosen
    if not _pool_chosen:
        _pool_chosen = True
        if "ARROW_DEFAULT_MEMORY_POOL" not in os.environ:
            pa.set_memory_pool(pa.system_memory_pool())


def pyarrow_version() -> str | None:
    """pyarrow's version where it imports, else None."""
    try:
        import pyarrow
    # a capability probe, as in _pyarrow_parquet
    except Exception:
        return None
    return pyarrow.__version__


class _RangeCache:
    """Sorted, non-overlapping (offset → bytes) ranges of one file."""

    def __init__(self) -> None:
        self._offsets: list[int] = []
        self._bufs: list[np.ndarray] = []
        self.miss_bytes = 0

    def insert(self, offset: int, buf: np.ndarray) -> None:
        i = bisect.bisect_left(self._offsets, offset)
        self._offsets.insert(i, offset)
        self._bufs.insert(i, buf)

    def read(self, offset: int, length: int, fallback) -> bytes:
        """Serve [offset, +length), stitching cached ranges; gaps fall back to
        *fallback(offset, length) -> bytes* on the real source (counted as
        miss bytes)."""
        out = bytearray(length)
        pos = offset
        end = offset + length
        while pos < end:
            i = bisect.bisect_right(self._offsets, pos) - 1
            hit = None
            if i >= 0:
                ro, rb = self._offsets[i], self._bufs[i]
                if ro <= pos < ro + len(rb):
                    hit = rb[pos - ro: pos - ro + (end - pos)]
            if hit is not None and len(hit) > 0:
                out[pos - offset: pos - offset + len(hit)] = hit.tobytes()
                pos += len(hit)
                continue
            # miss: read up to the next cached range (or to end)
            j = bisect.bisect_right(self._offsets, pos)
            stop = min(end, self._offsets[j]) if j < len(self._offsets) else end
            data = fallback(pos, stop - pos)
            if not data:
                return bytes(out[: pos - offset])  # EOF
            out[pos - offset: pos - offset + len(data)] = data
            self.miss_bytes += len(data)
            pos += len(data)
        return bytes(out)


class RangeCachedFile:
    """File-like object over a _RangeCache; what pyarrow decodes from.

    pyarrow wraps this in a PythonFile; all reads it issues for the footer and
    the selected column chunks are served from engine-prefetched ranges."""

    def __init__(self, path: str, cache: _RangeCache, *,
                 ctx: "StromContext | None" = None):
        """Misses pread the real file — or, when *ctx* aliases *path* to a
        striped set (``register_striped``), gather through the engine."""
        self._cache = cache
        striped = ctx.striped_source(path) if ctx is not None else None
        if striped is not None:
            self._fd = -1
            self._size = source_size(striped)
            self._fallback = lambda off, ln: ctx.pread(
                striped, off, min(ln, self._size - off)).tobytes()
        else:
            self._fd = os.open(path, os.O_RDONLY)
            self._size = os.fstat(self._fd).st_size
            self._fallback = lambda off, ln: os.pread(self._fd, ln, off)
        self._pos = 0
        self._closed = False

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self._size - self._pos
        n = max(0, min(n, self._size - self._pos))
        data = self._cache.read(self._pos, n, self._fallback)
        self._pos += len(data)
        return data

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = offset
        elif whence == os.SEEK_CUR:
            self._pos += offset
        elif whence == os.SEEK_END:
            self._pos = self._size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def size(self) -> int:
        return self._size

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def flush(self) -> None:
        pass

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def miss_bytes(self) -> int:
        return self._cache.miss_bytes

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self._fd >= 0:
                os.close(self._fd)


# --- direct PLAIN-page decode (the I/O-bound scan path) ---------------------

_PHYSICAL_NP = {
    "INT32": np.dtype("<i4"),
    "INT64": np.dtype("<i8"),
    "FLOAT": np.dtype("<f4"),
    "DOUBLE": np.dtype("<f8"),
}


class _PlainDecodeUnsupported(Exception):
    """Chunk needs the pyarrow fallback (not an error)."""


def _plain_logical_ok(col_schema, physical_type: str) -> bool:
    """True iff the column's logical/converted annotation is absent or
    exactly the physical numpy meaning, so frombuffer over the raw bytes
    returns what pyarrow would: a uint32 column is physically INT32, and
    date32/timestamp decode to datetime64 in pyarrow. Only no annotation,
    or a signed INT annotation of exactly the physical width, qualifies
    (a legacy converted type alone reads as the logical type it implies,
    as pyarrow reads it)."""
    lt = col_schema.logical_type
    if lt.type in ("NONE", "UNDEFINED"):
        return col_schema.converted_type == "NONE"
    if lt.type == "INT":
        width = {"INT32": 32, "INT64": 64}.get(physical_type)
        return (width is not None and lt.bit_width == width
                and lt.is_signed is True)
    return False


def column_dtype(col_schema, physical_type: str) -> np.dtype:
    """The numpy dtype a numeric column decodes to (as pyarrow's
    ``to_numpy`` gives it): the physical type's, or for an INT annotation
    the integer of its width and sign. Any other column raises TypeError."""
    lt = col_schema.logical_type
    if physical_type in _PHYSICAL_NP and _plain_logical_ok(col_schema,
                                                           physical_type):
        return _PHYSICAL_NP[physical_type]
    if lt.type == "INT" and physical_type in ("INT32", "INT64") \
            and lt.bit_width in (8, 16, 32, 64):
        return np.dtype(f"<{'i' if lt.is_signed else 'u'}{lt.bit_width // 8}")
    raise TypeError(f"column {col_schema.path!r} ({physical_type}, "
                    f"{col_schema.logical_type!r}) is not numeric")


def _defs_all_present(buf, num_values: int) -> bool:
    """True iff an RLE/bit-packed (bit width 1) definition-level block is all
    ones — i.e. no nulls. *buf* is the block AFTER its 4-byte length prefix."""
    pos = 0
    seen = 0
    while seen < num_values and pos < len(buf):
        header, pos = _uvarint(buf, pos)
        if header & 1:  # bit-packed run: (header>>1) groups of 8 values
            n_groups = header >> 1
            n_bytes = n_groups  # bit width 1: one byte per 8 values
            take = min(n_groups * 8, num_values - seen)
            full, rem = divmod(take, 8)
            block = buf[pos: pos + n_bytes]
            if any(b != 0xFF for b in block[:full]):
                return False
            if rem and (block[full] & ((1 << rem) - 1)) != (1 << rem) - 1:
                return False
            pos += n_bytes
            seen += take
        else:  # RLE run: value repeated (header>>1) times, 1 byte at width 1
            count = header >> 1
            if count == 0:
                return False  # malformed; be conservative
            if buf[pos] != 1:
                return False
            pos += 1
            seen += min(count, num_values - seen)
    return seen >= num_values


def decode_plain_pages(col_meta, col_schema, buf: np.ndarray
                       ) -> list[np.ndarray]:
    """Decode one uncompressed PLAIN numeric column chunk into per-page
    numpy VIEWS over its raw bytes (zero copies; the page list is the
    chunk's row order).

    *col_meta*: the chunk's ColumnChunkMetaData; *col_schema*: the matching
    ColumnSchema (for max def/rep levels); *buf*: the chunk's bytes
    (np.uint8, offset 0 = the chunk's first page header).
    Raises _PlainDecodeUnsupported when any page needs the pyarrow path.
    """
    if col_meta.compression != "UNCOMPRESSED":
        raise _PlainDecodeUnsupported(col_meta.compression)
    if col_meta.dictionary_page_offset is not None:
        raise _PlainDecodeUnsupported("dictionary-encoded")
    np_dtype = _PHYSICAL_NP.get(col_meta.physical_type)
    if np_dtype is None:
        raise _PlainDecodeUnsupported(col_meta.physical_type)
    if not _plain_logical_ok(col_schema, col_meta.physical_type):
        raise _PlainDecodeUnsupported(
            f"logical type {col_schema.logical_type} != physical "
            f"{col_meta.physical_type}")
    if col_schema.max_repetition_level:
        raise _PlainDecodeUnsupported("nested (repetition levels)")
    max_def = col_schema.max_definition_level
    stats = col_meta.statistics
    nulls_known_zero = stats is not None and stats.has_null_count \
        and stats.null_count == 0
    if max_def > 1 and not nulls_known_zero:
        # _defs_all_present parses bit-width-1 blocks only; a wider def
        # level (optional leaf inside an optional group) would be misparsed
        raise _PlainDecodeUnsupported("max_definition_level > 1")
    mv = buf if isinstance(buf, (bytes, memoryview)) else memoryview(buf)
    try:
        return _walk_plain_pages(mv, col_meta.num_values, np_dtype, max_def,
                                 nulls_known_zero)
    except (IndexError, ValueError, TypeError, RecursionError) as e:
        # truncated/corrupt chunk bytes (a header walk past the buffer,
        # frombuffer over a short page, a malformed def-level block or
        # thrift value, a missing header field arithmetic'd as None) are a
        # "can't prove safe" case like any other: pyarrow's own decode then
        # produces the authoritative error
        raise _PlainDecodeUnsupported(f"malformed chunk: {e!r}") from None


def _walk_plain_pages(mv, total: int, np_dtype, max_def: int,
                      nulls_known_zero: bool) -> list[np.ndarray]:
    parts: list[np.ndarray] = []
    pos = 0
    decoded = 0
    while decoded < total:
        header, pos = _thrift_struct(mv, pos)
        page_type = header.get(1)
        comp_size = header.get(3)
        # negative sizes/counts are crafted-input territory: comp_size < 0
        # walks the cursor BACKWARD onto the same header and num_values <= 0
        # never advances `decoded` (frombuffer treats any negative count as
        # "all") — an infinite loop, not an exception, so guard explicitly
        if not isinstance(comp_size, int) or comp_size < 0:
            raise _PlainDecodeUnsupported(f"bad page size {comp_size}")
        page_end = pos + comp_size
        if page_type != 0:  # 0 = DATA_PAGE (v1); v2/dict/index -> fallback
            raise _PlainDecodeUnsupported(f"page type {page_type}")
        dph = header.get(5)
        if not isinstance(dph, dict):
            raise _PlainDecodeUnsupported("no data page header")
        num_values = dph.get(1)
        encoding = dph.get(2)
        def_enc = dph.get(3)
        if not isinstance(num_values, int) or num_values <= 0:
            raise _PlainDecodeUnsupported(f"bad num_values {num_values}")
        if encoding != 0:  # PLAIN
            raise _PlainDecodeUnsupported(f"encoding {encoding}")
        vpos = pos
        if max_def:
            if def_enc != 3:  # RLE
                raise _PlainDecodeUnsupported(f"def-level encoding {def_enc}")
            dlen = int.from_bytes(mv[vpos: vpos + 4], "little")
            if not nulls_known_zero and not _defs_all_present(
                    mv[vpos + 4: vpos + 4 + dlen], num_values):
                raise _PlainDecodeUnsupported("nulls present")
            vpos += 4 + dlen
        want = num_values * np_dtype.itemsize
        if vpos + want > page_end:
            raise _PlainDecodeUnsupported("page shorter than its values")
        parts.append(np.frombuffer(mv, np_dtype, count=num_values,
                                   offset=vpos))
        decoded += num_values
        pos = page_end
    return parts


def decode_plain_chunk(col_meta, col_schema, buf: np.ndarray) -> np.ndarray:
    """:func:`decode_plain_pages` joined to one array (a view when the chunk
    is a single page, else one concatenation)."""
    parts = decode_plain_pages(col_meta, col_schema, buf)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


class ParquetShard:
    """One Parquet file: metadata once, column chunks as ExtentLists."""

    def __init__(self, path: str, *, ctx: "StromContext | None" = None):
        """The footer is read through *ctx* when one is given (which also
        serves a path aliased to a striped set with ``register_striped``:
        then every chunk and footer gather stripe-decodes and the file need
        not exist on disk), else with ``os.pread``."""
        self.path = path
        self._ctx = ctx
        self._striped = ctx.striped_source(path) if ctx is not None else None
        if ctx is not None:
            self._size = source_size(ctx.resolve_source(path))
            self.metadata = read_file_metadata(
                lambda off, n: ctx.pread(path, off, n).tobytes(), self._size,
                path)
        else:
            fd = os.open(path, os.O_RDONLY)
            try:
                self._size = os.fstat(fd).st_size
                self.metadata = read_file_metadata(
                    lambda off, n: os.pread(fd, n, off), self._size, path)
            finally:
                os.close(fd)
        self._footer_bytes: np.ndarray | None = None  # engine-read once, reused
        # scan decode pools read row groups of one shard concurrently; the
        # lock keeps "read once" true under that concurrency
        self._footer_lock = make_lock("app.parquet_footer")
        self._col_index = {
            self.metadata.schema.column(i).path: i
            for i in range(self.metadata.num_columns)
        }

    @property
    def num_row_groups(self) -> int:
        return self.metadata.num_row_groups

    @property
    def num_rows(self) -> int:
        return self.metadata.num_rows

    @property
    def column_names(self) -> list[str]:
        return list(self._col_index)

    def _col_indices(self, columns: Sequence[str] | None) -> list[int]:
        if columns is None:
            return list(range(self.metadata.num_columns))
        out = []
        for c in columns:
            if c not in self._col_index:
                raise KeyError(f"no column {c!r} in {self.path} "
                               f"(have {self.column_names})")
            out.append(self._col_index[c])
        return out

    def column_dtype(self, column: str) -> np.dtype:
        """The numpy dtype *column* decodes to (:func:`column_dtype`)."""
        cs = self.metadata.schema.column(self._col_indices([column])[0])
        return column_dtype(cs, cs.physical_type)

    def column_chunk_extents(self, row_group: int,
                             columns: Sequence[str] | None = None) -> ExtentList:
        """Byte ranges of the selected columns' compressed chunks in one row
        group (dictionary page included when present)."""
        rg = self.metadata.row_group(row_group)
        exts = []
        for ci in self._col_indices(columns):
            col = rg.column(ci)
            start = col.data_page_offset
            if col.dictionary_page_offset is not None:
                start = min(start, col.dictionary_page_offset)
            exts.append(Extent(self.path, start, col.total_compressed_size))
        return ExtentList(exts)

    def footer_extent(self) -> ExtentList:
        """The footer region. pyarrow speculatively reads the trailing 64KiB
        to find the footer, so cover at least that (or the whole thrift
        metadata + 4-byte length + 'PAR1' when it's bigger)."""
        flen = min(self._size, max(self.metadata.serialized_size + 8,
                                   64 * 1024))
        return ExtentList([Extent(self.path, self._size - flen, flen)])

    def read_row_group(self, ctx: "StromContext", row_group: int,
                       columns: Sequence[str] | None = None, *,
                       tenant: str | None = None) -> "pa.Table":
        """Engine-read the selected chunks + footer, decode to a pyarrow
        Table. Everything pyarrow touches was prefetched through the
        engine, in *tenant*'s scheduler queue. Raises RuntimeError where
        pyarrow does not import."""
        pq = _pyarrow_parquet(f"reading {self.path} row group {row_group} "
                              f"through its pyarrow route")
        chunk_ext = self.column_chunk_extents(row_group, columns)
        footer_ext = self.footer_extent()
        with self._footer_lock:
            if self._footer_bytes is None:
                self._footer_bytes = ctx.pread(footer_ext, tenant=tenant)
        buf = ctx.pread(chunk_ext, tenant=tenant)
        cache = _RangeCache()
        cache.insert(footer_ext.extents[0].offset, self._footer_bytes)
        pos = 0
        for e in chunk_ext.extents:
            cache.insert(e.offset, buf[pos: pos + e.length])
            pos += e.length
        f = RangeCachedFile(self.path, cache, ctx=self._ctx)
        try:
            pf = pq.ParquetFile(f)
            table = pf.read_row_group(
                row_group, columns=list(columns) if columns is not None else None)
        finally:
            f.close()
        if cache.miss_bytes:
            ctx._count(parquet_cache_miss_bytes=cache.miss_bytes)
        return table

    def _plain_eligible(self, rg, cis: list[int]) -> bool:
        for ci in cis:
            col = rg.column(ci)
            cs = self.metadata.schema.column(ci)
            if (col.compression != "UNCOMPRESSED"
                    or col.dictionary_page_offset is not None
                    or col.physical_type not in _PHYSICAL_NP
                    or not _plain_logical_ok(cs, col.physical_type)
                    or cs.max_repetition_level):
                return False
        return True

    def read_row_group_pages(self, ctx: "StromContext", row_group: int,
                             columns: Sequence[str], *,
                             out: np.ndarray | None = None,
                             tenant: str | None = None) -> dict:
        """Selected columns of one row group, each as a list of host numpy
        arrays in row order: the scan pipeline's read unit.

        Uncompressed PLAIN numeric chunks take the direct-decode path: ONE
        engine gather of the selected chunks, and each column's list is its
        pages as ``frombuffer`` views into that slab, no copy. Any column
        the fast path can't prove safe routes the whole group through
        :meth:`read_row_group` (one array a column; results identical). The
        context's ``parquet_plain_bytes`` / ``parquet_decode_bytes``
        counters record which path bytes took.

        *out*: a host buffer of at least the selected chunks' bytes for the
        PLAIN route's gather (a recycled, prefaulted slab), which the pages
        then view; else the gather lands in a fresh one. *tenant*: whose
        scheduler queue the gathers take."""
        rg = self.metadata.row_group(row_group)
        cis = self._col_indices(columns)
        if self._plain_eligible(rg, cis):
            chunk_ext = self.column_chunk_extents(row_group, columns)
            buf = ctx.pread(chunk_ext, tenant=tenant) if out is None \
                else ctx.memcpy_ssd2host(chunk_ext, out=out, tenant=tenant)
            pages = {}
            pos = 0
            try:
                for name, ci, ext in zip(columns, cis, chunk_ext.extents):
                    pages[name] = decode_plain_pages(
                        rg.column(ci), self.metadata.schema.column(ci),
                        buf[pos: pos + ext.length])
                    pos += ext.length
            except _PlainDecodeUnsupported:
                pass  # a data-level surprise: the pyarrow route below
            else:
                ctx._count(parquet_plain_bytes=int(buf.nbytes))
                return pages
        table = self.read_row_group(ctx, row_group, columns=columns,
                                    tenant=tenant)
        pages = {c: [np.ascontiguousarray(
                     table[c].to_numpy(zero_copy_only=False))]
                 for c in columns}
        ctx._count(parquet_decode_bytes=int(
            sum(p[0].nbytes for p in pages.values())))
        return pages

    def read_row_group_arrays(self, ctx: "StromContext", row_group: int,
                              columns: Sequence[str], *,
                              tenant: str | None = None) -> dict:
        """Selected columns of one row group as host numpy arrays: the
        pages of :meth:`read_row_group_pages` joined (a view where a chunk
        is one page, else one concatenation). *tenant*: whose scheduler
        queue the gathers take."""
        return {c: p[0] if len(p) == 1 else np.concatenate(p)
                for c, p in self.read_row_group_pages(
                    ctx, row_group, columns, tenant=tenant).items()}


# --- the PLAIN writer ------------------------------------------------------

# parquet-cpp's cap on the rows of a data page (pyarrow's
# data_page_row_count_limit); a page is also what decode_plain_pages views
PAGE_ROWS = 20_000
_WRITE_TYPES = {("i", 4): "INT32", ("i", 8): "INT64", ("f", 4): "FLOAT",
                ("f", 8): "DOUBLE"}
CREATED_BY = "strom_torch version 0.1.0"


def _all_present_levels(n: int) -> bytes:
    """The definition levels of *n* present values at bit width 1: one RLE
    run of ones, behind its 4-byte length (as pyarrow writes a nullable
    leaf without nulls)."""
    header = n << 1
    run = bytearray()
    while True:
        b = header & 0x7F
        header >>= 7
        run.append(b | (0x80 if header else 0))
        if not header:
            break
    run.append(1)
    return len(run).to_bytes(4, "little") + bytes(run)


def _chunk_stats(a: np.ndarray) -> list:
    """A chunk's Statistics: min and max (NaN ignored; none where every
    value is NaN; a zero minimum written as -0.0 and a zero maximum as
    +0.0, as the format asks of floats), and a null count of 0."""
    if a.dtype.kind == "f":
        lo, hi = np.fmin.reduce(a), np.fmax.reduce(a)
        if np.isnan(lo):
            return encode_statistics(None, None, 0)
        lo = a.dtype.type(-0.0) if lo == 0 else lo
        hi = a.dtype.type(0.0) if hi == 0 else hi
    else:
        lo, hi = a.min(), a.max()
    return encode_statistics(np.asarray(lo, a.dtype).tobytes(),
                             np.asarray(hi, a.dtype).tobytes(), 0)


def write_parquet(ctx, path: str, columns: "dict[str, np.ndarray]", *,
                  row_group_rows: "int | None" = None,
                  compression: str = "NONE",
                  fsync: bool = True) -> int:
    """Write *columns* (equal-length 1-D arrays) as a Parquet file through
    the engine's write path (``ctx.pwrite``, the machinery that reads it
    back); returns bytes written.

    ``compression="NONE"`` (the default) is the native PLAIN writer: every
    column an OPTIONAL leaf with an all-present definition-level run (as
    pyarrow writes a nullable column without nulls), v1 data pages of at
    most :data:`PAGE_ROWS` rows, no dictionary, per-chunk statistics
    (``min_value``, ``max_value``, ``null_count`` 0); int32, int64, float32
    and float64 only, anything else raises TypeError. The file reads back
    on the zero-copy PLAIN route. Any other *compression* is serialised by
    pyarrow (RuntimeError where it is absent). Either way the file is
    assembled in a page-aligned host buffer and handed to ``ctx.pwrite``;
    an existing file is cut to the new size first."""
    if compression.upper() not in ("NONE", "UNCOMPRESSED"):
        return _pwrite_parts(ctx, path, [_pyarrow_bytes(
            columns, row_group_rows, compression)], fsync)
    arrays: list[tuple[str, np.ndarray, str]] = []
    n = None
    for name, v in columns.items():
        a = np.asarray(v)
        ptype = _WRITE_TYPES.get((a.dtype.kind, a.dtype.itemsize))
        if ptype is None or a.ndim != 1:
            raise TypeError(f"write_parquet writes 1-D int32, int64, float32 "
                            f"and float64 columns; {name!r} is "
                            f"{a.dtype} of shape {a.shape}")
        if n is not None and len(a) != n:
            raise ValueError(f"column {name!r} has {len(a)} rows, others "
                             f"{n}")
        n = len(a)
        arrays.append((name, np.ascontiguousarray(
            a, dtype=a.dtype.newbyteorder("<")), ptype))
    if n is None:
        raise ValueError("write_parquet needs at least one column")
    rg_rows = row_group_rows or max(n, 1)
    row_groups = []
    parts: list = [b"PAR1"]
    pos = 4
    for r0 in range(0, n, rg_rows):
        r1 = min(n, r0 + rg_rows)
        chunks = []
        for _, a, _ in arrays:
            start = pos
            for p0 in range(r0, r1, PAGE_ROWS):
                values = a[p0: min(r1, p0 + PAGE_ROWS)]
                defs = _all_present_levels(len(values))
                header = encode_data_page_header(
                    len(values), len(defs) + values.nbytes)
                parts += [header, defs, values.view(np.uint8)]
                pos += len(header) + len(defs) + values.nbytes
            chunks.append({"offset": start, "size": pos - start,
                           "num_values": r1 - r0,
                           "stats": _chunk_stats(a[r0:r1])})
        row_groups.append({"num_rows": r1 - r0,
                           "file_offset": chunks[0]["offset"],
                           "chunks": chunks})
    meta = encode_file_metadata([(name, t) for name, _, t in arrays], n,
                                row_groups, CREATED_BY)
    parts += [meta, len(meta).to_bytes(4, "little") + b"PAR1"]
    return _pwrite_parts(ctx, path, parts, fsync)


def _pwrite_parts(ctx, path: str, parts: list, fsync: bool) -> int:
    """Join *parts* (bytes-like) into one page-aligned buffer, so the
    engine's aligned pieces ride O_DIRECT, and ``ctx.pwrite`` it."""
    views = [p if isinstance(p, np.ndarray)
             else np.frombuffer(p, dtype=np.uint8) for p in parts]
    total = sum(v.nbytes for v in views)
    buf = alloc_aligned(total)
    pos = 0
    for v in views:
        buf[pos: pos + v.nbytes] = v
        pos += v.nbytes
    truncate_to(path, total)
    return ctx.pwrite(path, buf, fsync=fsync)


def _pyarrow_bytes(columns: dict, row_group_rows, compression: str):
    """*columns* serialised by pyarrow (no dictionary) into a buffer."""
    pq = _pyarrow_parquet(f"write_parquet(compression={compression!r})")
    import pyarrow as pa

    table = pa.table({k: pa.array(np.asarray(v)) for k, v in columns.items()})
    sink = pa.BufferOutputStream()
    pq.write_table(table, sink, compression=compression.lower(),
                   use_dictionary=False,
                   row_group_size=row_group_rows or len(table))
    return sink.getvalue()
