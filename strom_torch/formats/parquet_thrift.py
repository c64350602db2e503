"""Parquet's Thrift compact protocol, read and written: the page headers the
PLAIN decoder walks, the file footer (``FileMetaData``) a shard is planned
from, and the encoder behind the port's PLAIN writer.

The reference reads every footer with pyarrow (``pq.read_metadata``) and
walks page headers with its own decoder (``_uvarint``, ``_zigzag``,
``_thrift_skip``, ``_thrift_struct`` in ``strom/formats/parquet.py``).
Those four are copied here and extended to decode what a footer holds:
binaries as ``bytes``, doubles, the byte type and lists. Crafted input
raises :class:`ThriftError` (a ``ValueError``): a list may not claim more
elements than bytes remain, and structs may not nest deeper than
``MAX_DEPTH``, so no input loops or allocates without bound.

:func:`read_file_metadata` returns objects with the attribute names the
reference reads from pyarrow's metadata (``num_rows``, ``schema.column(i)
.path``, ``row_group(g).column(i).statistics.min``, ...), so code copied
from the reference reads the same way in both packages. Statistics decode
for INT32, INT64, FLOAT and DOUBLE columns whose annotation is absent or an
integer one; any other column has none, so it refutes no predicate.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Callable

# compact-protocol field and element types
T_TRUE, T_FALSE, T_BYTE, T_I16, T_I32, T_I64, T_DOUBLE, T_BINARY, T_LIST, \
    T_SET, T_MAP, T_STRUCT = range(1, 13)
MAX_DEPTH = 64

PHYSICAL_TYPES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
                  "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
# pyarrow's names for the codecs (thrift LZ4 is the Hadoop framing)
COMPRESSION = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI",
               "LZ4_HADOOP", "ZSTD", "LZ4")
CONVERTED_TYPES = ("UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL",
                   "DATE", "TIME_MILLIS", "TIME_MICROS", "TIMESTAMP_MILLIS",
                   "TIMESTAMP_MICROS", "UINT_8", "UINT_16", "UINT_32",
                   "UINT_64", "INT_8", "INT_16", "INT_32", "INT_64", "JSON",
                   "BSON", "INTERVAL")
# LogicalType union members (field id -> pyarrow's ``logical_type.type``)
LOGICAL_TYPES = {1: "STRING", 2: "MAP", 3: "LIST", 4: "ENUM", 5: "DECIMAL",
                 6: "DATE", 7: "TIME", 8: "TIMESTAMP", 10: "INT",
                 11: "NULL", 12: "JSON", 13: "BSON", 14: "UUID",
                 15: "FLOAT16", 16: "VARIANT", 17: "GEOMETRY",
                 18: "GEOGRAPHY"}
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2


class ThriftError(ValueError):
    """Bytes that are not a well-formed compact-protocol value."""


# --- decoder -----------------------------------------------------------------
def _uvarint(buf, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ThriftError("varint overflow")


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _list_head(buf, pos: int) -> tuple[int, int, int]:
    """(size, element type, pos) of a list or set header; a size beyond the
    bytes left is refused (every element takes at least one byte)."""
    head = buf[pos]
    pos += 1
    size = head >> 4
    etype = head & 0x0F
    if size == 15:
        size, pos = _uvarint(buf, pos)
    if size > len(buf) - pos:
        raise ThriftError(f"list of {size} elements in {len(buf) - pos} "
                          f"bytes")
    return size, etype, pos


def _binary(buf, pos: int) -> tuple[bytes, int]:
    n, pos = _uvarint(buf, pos)
    if pos + n > len(buf):
        raise ThriftError(f"binary of {n} bytes past the buffer")
    return bytes(buf[pos: pos + n]), pos + n


def _thrift_skip(buf, pos: int, ftype: int, depth: int = 0) -> int:
    """Skip one thrift compact value of *ftype*; returns new pos."""
    if ftype in (T_TRUE, T_FALSE):  # value is in the type
        return pos
    if ftype == T_BYTE:
        return pos + 1
    if ftype in (T_I16, T_I32, T_I64):  # zigzag varint
        _, pos = _uvarint(buf, pos)
        return pos
    if ftype == T_DOUBLE:
        return pos + 8
    if ftype == T_BINARY:
        n, pos = _uvarint(buf, pos)
        return pos + n
    if ftype in (T_LIST, T_SET):
        size, etype, pos = _list_head(buf, pos)
        if etype in (T_TRUE, T_FALSE):
            # bool ELEMENTS are one byte each (0x01/0x02) — unlike bool
            # struct FIELDS, whose value rides the field-type nibble
            return pos + size
        for _ in range(size):
            pos = _thrift_skip(buf, pos, etype, depth + 1)
        return pos
    if ftype == T_STRUCT:
        if depth > MAX_DEPTH:
            raise ThriftError(f"structs nested deeper than {MAX_DEPTH}")
        while True:
            fb = buf[pos]
            pos += 1
            if fb == 0:
                return pos
            if fb >> 4 == 0:  # long-form field id: zigzag varint follows
                _, pos = _uvarint(buf, pos)
            pos = _thrift_skip(buf, pos, fb & 0x0F, depth + 1)
    raise ThriftError(f"thrift type {ftype}")


def _thrift_value(buf, pos: int, ftype: int, depth: int) -> tuple[Any, int]:
    """One value of *ftype* (a list element or a field's value)."""
    if ftype in (T_I16, T_I32, T_I64):
        sv, pos = _uvarint(buf, pos)
        return _zigzag(sv), pos
    if ftype == T_BINARY:
        return _binary(buf, pos)
    if ftype == T_STRUCT:
        return _thrift_struct(buf, pos, depth + 1)
    if ftype == T_BYTE:
        b = buf[pos]
        return b - 256 if b > 127 else b, pos + 1
    if ftype == T_DOUBLE:
        if pos + 8 > len(buf):
            raise ThriftError("double past the buffer")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ftype in (T_LIST, T_SET):
        size, etype, pos = _list_head(buf, pos)
        out = []
        for _ in range(size):
            if etype in (T_TRUE, T_FALSE):
                out.append(buf[pos] == T_TRUE)
                pos += 1
            else:
                v, pos = _thrift_value(buf, pos, etype, depth + 1)
                out.append(v)
        return out, pos
    raise ThriftError(f"thrift type {ftype}")


def _thrift_struct(buf, pos: int, depth: int = 0) -> tuple[dict, int]:
    """Parse a thrift compact struct into {field_id: value}: bools, ints
    (zigzag-decoded), doubles, binaries as ``bytes``, lists as lists and
    nested structs as dicts. Maps (which Parquet's structs do not use)
    raise."""
    if depth > MAX_DEPTH:
        raise ThriftError(f"structs nested deeper than {MAX_DEPTH}")
    out: dict = {}
    fid = 0
    while True:
        fb = buf[pos]
        pos += 1
        if fb == 0:
            return out, pos
        delta = fb >> 4
        ftype = fb & 0x0F
        if delta:
            fid += delta
        else:
            sv, pos = _uvarint(buf, pos)
            fid = _zigzag(sv)
        if ftype in (T_TRUE, T_FALSE):
            out[fid] = ftype == T_TRUE
        else:
            out[fid], pos = _thrift_value(buf, pos, ftype, depth)


# --- footer objects ----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LogicalType:
    """A column's logical annotation; ``type`` is pyarrow's name for it
    (``"NONE"`` when absent), ``bit_width``/``is_signed`` an INT's."""

    type: str = "NONE"
    bit_width: int | None = None
    is_signed: bool | None = None

    def __repr__(self) -> str:
        if self.type == "INT":
            return f"Int(bitWidth={self.bit_width}, isSigned={self.is_signed})"
        return self.type.capitalize()


_NONE = LogicalType()
# legacy converted types that name an integer: (bit width, signed)
_CONVERTED_INT = {f"{p}INT_{w}": (w, p == "") for p in ("", "U")
                  for w in (8, 16, 32, 64)}
# legacy converted types that name a logical type of the same name
_CONVERTED_SAME = {"MAP": "MAP", "LIST": "LIST", "ENUM": "ENUM",
                   "DECIMAL": "DECIMAL", "DATE": "DATE", "JSON": "JSON",
                   "BSON": "BSON", "INTERVAL": "INTERVAL", "UTF8": "STRING",
                   "TIME_MILLIS": "TIME", "TIME_MICROS": "TIME",
                   "TIMESTAMP_MILLIS": "TIMESTAMP",
                   "TIMESTAMP_MICROS": "TIMESTAMP"}
_TIME_UNITS = {1: "MILLIS", 2: "MICROS"}   # TimeUnit union (3: NANOS)


def _annotation(el: dict) -> tuple[LogicalType, str]:
    """A schema element's (logical type, converted type) as pyarrow reads
    them: a LogicalType union wins, and the converted type is the one it
    implies (a timestamp or time not adjusted to UTC implies none); a legacy
    file's converted type alone implies the logical type."""
    lt = el.get(10)
    if isinstance(lt, dict) and lt:
        fid, body = next(iter(lt.items()))
        kind = LOGICAL_TYPES.get(fid, "UNKNOWN")
        body = body if isinstance(body, dict) else {}
        if kind == "INT":
            w, signed = body.get(1), body.get(2)
            return (LogicalType("INT", w, signed),
                    f"{'' if signed else 'U'}INT_{w}")
        if kind in ("TIME", "TIMESTAMP"):
            unit = body.get(2)
            unit = _TIME_UNITS.get(next(iter(unit), None)) \
                if isinstance(unit, dict) else None
            conv = f"{kind}_{unit}" if body.get(1) is True and unit \
                else "NONE"
            return LogicalType(kind), conv
        conv = {"STRING": "UTF8", "MAP": "MAP", "LIST": "LIST",
                "ENUM": "ENUM", "DECIMAL": "DECIMAL", "DATE": "DATE",
                "JSON": "JSON", "BSON": "BSON"}.get(kind, "NONE")
        return LogicalType(kind), conv
    c = el.get(6)
    conv = CONVERTED_TYPES[c] if isinstance(c, int) \
        and 0 <= c < len(CONVERTED_TYPES) else "NONE"
    if conv in _CONVERTED_INT:
        w, signed = _CONVERTED_INT[conv]
        return LogicalType("INT", w, signed), conv
    return (LogicalType(_CONVERTED_SAME[conv]) if conv in _CONVERTED_SAME
            else _NONE), conv


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    """A leaf column (pyarrow's ``ParquetColumnSchema`` attributes)."""

    path: str
    name: str
    physical_type: str
    max_definition_level: int
    max_repetition_level: int
    logical_type: LogicalType
    converted_type: str


class ParquetSchema:
    """The leaf columns, in file order."""

    def __init__(self, columns: list[ColumnSchema]):
        self._columns = columns

    def column(self, i: int) -> ColumnSchema:
        return self._columns[i]

    def __len__(self) -> int:
        return len(self._columns)


@dataclasses.dataclass(frozen=True)
class Statistics:
    """A column chunk's statistics (pyarrow's ``Statistics`` attributes)."""

    has_min_max: bool
    min: Any
    max: Any
    has_null_count: bool
    null_count: int | None


@dataclasses.dataclass(frozen=True)
class ColumnChunkMetaData:
    physical_type: str
    compression: str
    num_values: int
    data_page_offset: int
    dictionary_page_offset: int | None
    total_compressed_size: int
    path_in_schema: str
    statistics: Statistics | None


class RowGroupMetaData:
    def __init__(self, num_rows: int, columns: list[ColumnChunkMetaData]):
        self.num_rows = num_rows
        self.num_columns = len(columns)
        self._columns = columns

    def column(self, i: int) -> ColumnChunkMetaData:
        return self._columns[i]


class FileMetaData:
    """A decoded footer (pyarrow's ``FileMetaData`` attributes)."""

    def __init__(self, num_rows: int, schema: ParquetSchema,
                 row_groups: list[RowGroupMetaData], serialized_size: int):
        self.num_rows = num_rows
        self.schema = schema
        self._row_groups = row_groups
        self.num_row_groups = len(row_groups)
        self.num_columns = len(schema)
        self.serialized_size = serialized_size

    def row_group(self, i: int) -> RowGroupMetaData:
        return self._row_groups[i]


def _text(b: Any) -> str:
    if not isinstance(b, bytes):
        raise ThriftError(f"expected a string, got {type(b).__name__}")
    return b.decode("utf-8", errors="replace")


def _leaves(elements: list) -> list[ColumnSchema]:
    """The leaf columns of a depth-first SchemaElement list, with their
    dotted paths and max definition/repetition levels (each OPTIONAL or
    REPEATED ancestor below the root adds a definition level, each REPEATED
    one a repetition level)."""
    if not elements or not isinstance(elements[0], dict):
        raise ThriftError("empty schema")
    out: list[ColumnSchema] = []
    # (children left, path, def level, rep level) of each open group
    stack = [(elements[0].get(5, 0), (), 0, 0)]
    pos = 1
    while stack:
        left, path, dl, rl = stack[-1]
        if left == 0:
            stack.pop()
            continue
        stack[-1] = (left - 1, path, dl, rl)
        if pos >= len(elements) or not isinstance(elements[pos], dict):
            raise ThriftError("schema ends inside a group")
        el = elements[pos]
        pos += 1
        rep = el.get(3, REQUIRED)
        d, r = dl + (rep in (OPTIONAL, REPEATED)), rl + (rep == REPEATED)
        name = _text(el.get(4))
        if 1 not in el:   # a group
            n = el.get(5, 0)
            if not isinstance(n, int) or n < 0 or n > len(elements) - pos:
                raise ThriftError(f"group {name!r} claims {n} children")
            if len(stack) > MAX_DEPTH:
                raise ThriftError(f"groups nested deeper than {MAX_DEPTH}")
            stack.append((n, path + (name,), d, r))
            continue
        ptype = el[1]
        logical, converted = _annotation(el)
        out.append(ColumnSchema(
            path=".".join(path + (name,)), name=name,
            physical_type=(PHYSICAL_TYPES[ptype]
                           if 0 <= ptype < len(PHYSICAL_TYPES) else "UNKNOWN"),
            max_definition_level=d, max_repetition_level=r,
            logical_type=logical, converted_type=converted))
    return out


_STAT_FMT = {"INT32": "<i", "INT64": "<q", "FLOAT": "<f", "DOUBLE": "<d"}


def _statistics(st: Any, col: ColumnSchema) -> Statistics | None:
    """Decode a Statistics struct for the numeric columns whose annotation
    is absent or an integer one; None for any other column."""
    fmt = _STAT_FMT.get(col.physical_type)
    lt = col.logical_type
    if not isinstance(st, dict) or fmt is None \
            or lt.type not in ("NONE", "INT"):
        return None
    unsigned = lt.type == "INT" and lt.is_signed is False
    if unsigned:
        if fmt not in ("<i", "<q"):
            return None
        fmt = fmt.upper()
    # min_value/max_value first; the legacy min/max were written in signed
    # order, so they serve only a column whose sort order is signed
    lo, hi = st.get(6), st.get(5)
    if lo is None or hi is None:
        lo, hi = (st.get(2), st.get(1)) if not unsigned else (None, None)
    size = struct.calcsize(fmt)
    has = all(isinstance(b, bytes) and len(b) == size for b in (lo, hi))
    nc = st.get(3)
    return Statistics(
        has_min_max=has,
        min=struct.unpack(fmt, lo)[0] if has else None,
        max=struct.unpack(fmt, hi)[0] if has else None,
        has_null_count=isinstance(nc, int), null_count=nc
        if isinstance(nc, int) else None)


def _column_chunk(cc: Any, col: ColumnSchema) -> ColumnChunkMetaData:
    if not isinstance(cc, dict) or not isinstance(cc.get(3), dict):
        raise ThriftError("column chunk without its metadata")
    md = cc[3]
    codec = md.get(4, 0)
    return ColumnChunkMetaData(
        physical_type=(PHYSICAL_TYPES[md[1]] if 0 <= md.get(1, -1)
                       < len(PHYSICAL_TYPES) else "UNKNOWN"),
        compression=(COMPRESSION[codec] if 0 <= codec < len(COMPRESSION)
                     else f"CODEC_{codec}"),
        num_values=md[5], data_page_offset=md[9],
        dictionary_page_offset=md.get(11),
        total_compressed_size=md[7],
        path_in_schema=".".join(_text(p) for p in md.get(3, [])),
        statistics=_statistics(md.get(12), col))


def parse_file_metadata(buf: bytes) -> FileMetaData:
    """FileMetaData from its Thrift bytes. Raises ThriftError (a
    ValueError) on bytes it cannot read."""
    try:
        d, _ = _thrift_struct(memoryview(buf), 0)
        columns = _leaves(d[2])
        row_groups = []
        for rg in d.get(4, []):
            ccs = rg[1]
            if len(ccs) != len(columns):
                raise ThriftError(f"row group of {len(ccs)} columns, schema "
                                  f"has {len(columns)}")
            row_groups.append(RowGroupMetaData(
                rg[3], [_column_chunk(cc, col) for cc, col in zip(ccs, columns)]))
        return FileMetaData(
            d[3], ParquetSchema(columns), row_groups, len(buf))
    except (IndexError, KeyError, TypeError, AttributeError) as e:
        raise ThriftError(f"malformed footer: {e!r}") from None


def read_file_metadata(read_at: Callable[[int, int], bytes], file_size: int,
                       name: str = "<file>") -> FileMetaData:
    """The footer of a Parquet file of *file_size* bytes, read through
    ``read_at(offset, length) -> bytes``: the trailing 4-byte length and
    ``PAR1``, then the Thrift ``FileMetaData``. A truncated file, bad magic,
    a length past the file or a malformed footer raises ValueError naming
    *name*."""
    if file_size < 12:
        raise ValueError(f"{name}: {file_size} bytes is too short for a "
                         f"Parquet file")
    tail = bytes(read_at(file_size - 8, 8))
    if len(tail) != 8 or tail[4:] != b"PAR1":
        raise ValueError(f"{name}: no Parquet magic at the end of the file")
    flen = int.from_bytes(tail[:4], "little")
    if flen <= 0 or flen + 12 > file_size:
        raise ValueError(f"{name}: footer length {flen} runs past the file "
                         f"({file_size} bytes)")
    buf = bytes(read_at(file_size - 8 - flen, flen))
    if len(buf) != flen:
        raise ValueError(f"{name}: footer truncated ({len(buf)} of {flen} "
                         f"bytes)")
    try:
        return parse_file_metadata(buf)
    except ThriftError as e:
        raise ValueError(f"{name}: {e}") from None


# --- encoder -----------------------------------------------------------------
def _enc_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_value(ftype: int, v: Any) -> bytes:
    if ftype in (T_I16, T_I32, T_I64):
        return _enc_uvarint((v << 1) ^ (v >> 63))
    if ftype == T_BINARY:
        b = v.encode() if isinstance(v, str) else bytes(v)
        return _enc_uvarint(len(b)) + b
    if ftype == T_STRUCT:
        return encode_struct(v)
    if ftype == T_LIST:
        etype, items = v
        head = bytes([len(items) << 4 | etype]) if len(items) < 15 \
            else bytes([0xF0 | etype]) + _enc_uvarint(len(items))
        return head + b"".join(_enc_value(etype, x) for x in items)
    raise ThriftError(f"cannot encode thrift type {ftype}")


def encode_struct(fields: list[tuple[int, int, Any]]) -> bytes:
    """A compact struct from ``(field id, type, value)`` in ascending id
    order; None values are left out. Types: ``T_TRUE`` for a bool (its value
    picks the nibble), ``T_I32``/``T_I64``, ``T_BINARY`` (bytes or str),
    ``T_STRUCT`` (a nested field list), ``T_LIST`` (``(element type,
    items)``)."""
    out = bytearray()
    last = 0
    for fid, ftype, v in fields:
        if v is None:
            continue
        if ftype in (T_TRUE, T_FALSE):
            ftype = T_TRUE if v else T_FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append(delta << 4 | ftype)
        else:
            out.append(ftype)
            out += _enc_uvarint((fid << 1) ^ (fid >> 63))
        last = fid
        if ftype not in (T_TRUE, T_FALSE):
            out += _enc_value(ftype, v)
    out.append(0)
    return bytes(out)


ENC_PLAIN, ENC_RLE = 0, 3


def encode_data_page_header(num_values: int, body_bytes: int) -> bytes:
    """A v1 DATA_PAGE header, uncompressed, PLAIN values, RLE levels."""
    return encode_struct([
        (1, T_I32, 0),                       # DATA_PAGE
        (2, T_I32, body_bytes),              # uncompressed_page_size
        (3, T_I32, body_bytes),              # compressed_page_size
        (5, T_STRUCT, [(1, T_I32, num_values), (2, T_I32, ENC_PLAIN),
                       (3, T_I32, ENC_RLE), (4, T_I32, ENC_RLE)])])


def encode_statistics(lo: bytes | None, hi: bytes | None,
                      null_count: int) -> list:
    """A Statistics field list: ``min_value``/``max_value`` when known."""
    return [(3, T_I64, null_count), (5, T_BINARY, hi), (6, T_BINARY, lo)]


def encode_file_metadata(columns: list[tuple[str, str]], num_rows: int,
                         row_groups: list[dict], created_by: str) -> bytes:
    """FileMetaData of a flat schema of OPTIONAL leaves.

    *columns*: ``(name, physical type)``; *row_groups*: dicts with
    ``num_rows``, ``file_offset`` and ``chunks``, one per column, each with
    ``offset`` (of its first page), ``size`` (bytes, headers included),
    ``num_values`` and ``stats`` (a :func:`encode_statistics` list)."""
    schema = [[(4, T_BINARY, "schema"), (5, T_I32, len(columns))]]
    schema += [[(1, T_I32, PHYSICAL_TYPES.index(t)), (3, T_I32, OPTIONAL),
                (4, T_BINARY, name)] for name, t in columns]
    rgs = []
    for ordinal, rg in enumerate(row_groups):
        ccs = []
        for (name, t), ch in zip(columns, rg["chunks"]):
            md = [(1, T_I32, PHYSICAL_TYPES.index(t)),
                  (2, T_LIST, (T_I32, [ENC_PLAIN, ENC_RLE])),
                  (3, T_LIST, (T_BINARY, [name])),
                  (4, T_I32, 0),              # UNCOMPRESSED
                  (5, T_I64, ch["num_values"]),
                  (6, T_I64, ch["size"]), (7, T_I64, ch["size"]),
                  (9, T_I64, ch["offset"]),
                  (12, T_STRUCT, ch["stats"])]
            ccs.append([(2, T_I64, ch["offset"]), (3, T_STRUCT, md)])
        size = sum(ch["size"] for ch in rg["chunks"])
        rgs.append([(1, T_LIST, (T_STRUCT, ccs)), (2, T_I64, size),
                    (3, T_I64, rg["num_rows"]), (5, T_I64, rg["file_offset"]),
                    (6, T_I64, size), (7, T_I16, ordinal)])
    return encode_struct([
        (1, T_I32, 2), (2, T_LIST, (T_STRUCT, schema)),
        (3, T_I64, num_rows), (4, T_LIST, (T_STRUCT, rgs)),
        (6, T_BINARY, created_by),
        # TypeDefinedOrder for every column: without it readers take the
        # legacy min/max, which this writer does not emit
        (7, T_LIST, (T_STRUCT, [[(1, T_STRUCT, [])] for _ in columns]))])
