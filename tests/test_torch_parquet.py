"""The port's Parquet format layer against the JAX package's and pyarrow's on
the CPU: the copied Thrift decoder on the reference's cases, crafted bytes
that must raise (never hang), the native footer reader field by field
against ``pq.read_metadata``, row-group statistics and predicate
refutation against the reference, the PLAIN route (and its pyarrow
fallbacks) against the reference's reads, the native PLAIN writer read back
by pyarrow and by the reference's PLAIN route, the port with pyarrow
hidden, and a shard on a striped set."""

import datetime
import json
import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.formats import parquet as jpq
from strom.ops import pushdown as jpd
from strom.utils.stats import global_stats
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.engine.raid0 import stripe_file
from strom_torch.formats import parquet as tpq
from strom_torch.formats import parquet_thrift as thr
from strom_torch.ops import pushdown as tpd

ROWS, GROUP = 5000, 2000
NUMERIC = ("i32", "i64", "f32", "f64", "u32")


def _table(rng, n=ROWS) -> pa.Table:
    u32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    u32[0] = 2147483653   # past 2^31: the signed reading would be negative
    return pa.table({
        "i32": pa.array(rng.integers(-(1 << 20), 1 << 20, n, dtype=np.int32)),
        "i64": pa.array(rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64)),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "f64": pa.array(rng.standard_normal(n)),
        "u32": pa.array(u32),
        "d32": pa.array(rng.integers(0, 30000, n).astype(np.int32),
                        type=pa.date32()),
        "nul": pa.array([None if i % 3 == 1 else float(i) for i in range(n)]),
    })


# name -> pq.write_table keywords
FILES = {
    "plain": dict(compression="NONE", use_dictionary=False),
    "plain_nostats": dict(compression="NONE", use_dictionary=False,
                          write_statistics=False),
    "snappy": dict(compression="snappy", use_dictionary=False),
    "dictionary": dict(compression="NONE"),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """pyarrow-written files of every kind in FILES (3 row groups of the
    seven columns of _table), one 50,000-row PLAIN file of 2-page chunks,
    and one with a struct leaf and a list."""
    td = tmp_path_factory.mktemp("tpq")
    rng = np.random.default_rng(11)
    table = _table(rng)
    out = {}
    for name, kw in FILES.items():
        p = str(td / f"{name}.parquet")
        pq.write_table(table, p, row_group_size=GROUP, **kw)
        out[name] = (p, table)
    big = _table(rng, 50_000)
    p = str(td / "pages.parquet")
    pq.write_table(big, p, row_group_size=30_000, compression="NONE",
                   use_dictionary=False)
    out["pages"] = (p, big)
    nested = pa.table({
        "s": pa.array([{"v": float(i)} for i in range(2000)],
                      type=pa.struct([("v", pa.float64())])),
        "l": pa.array([[i, i + 1] for i in range(2000)],
                      type=pa.list_(pa.int32())),
        "ts": pa.array(np.arange(2000, dtype=np.int64),
                       type=pa.timestamp("us")),
        "s8": pa.array(np.arange(2000) % 100, type=pa.int8())})
    p = str(td / "nested.parquet")
    pq.write_table(nested, p, compression="NONE", use_dictionary=False)
    out["nested"] = (p, nested)
    return out


@pytest.fixture(scope="module")
def ctxs():
    """(port context, JAX package's context), both on the preadv pool."""
    t = StromContext(StromConfig(engine="python", queue_depth=8,
                                 num_buffers=8))
    j = JContext(JConfig(engine="python", queue_depth=8, num_buffers=8))
    yield t, j
    t.close()
    j.close()


def _counts(ctx) -> tuple[int, int]:
    """The port's PLAIN and pyarrow byte counters, through the context's
    scope of the process-wide registry."""
    st = ctx.scope.snapshot()
    return st.get("parquet_plain_bytes", 0), st.get("parquet_decode_bytes", 0)


def _jcounts() -> tuple[int, int]:
    snap = global_stats.snapshot()
    return (snap.get("parquet_plain_bytes", 0),
            snap.get("parquet_decode_bytes", 0))


# ------------------------------------------------------------ thrift decoder
def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


# the reference's hand-built structs (tests/test_formats.py
# test_thrift_skip_field_types, test_thrift_skip_bool_list_elements)
REF_STRUCTS = {
    "field_types": bytes([0x11, 0x17, *([0x40] * 8), 0x18, 0x03, 0x61, 0x62,
                          0x63, 0x19, 0x25, 0x02, 0x04, 0x1C, 0x15, 0x06,
                          0x00, 0x05, 0x0E, 0x2A, 0x00]),
    "bool_list": bytes([0x19, 0x31, 0x01, 0x02, 0x01, 0x25, 0x2A, 0x00]),
}


@pytest.mark.parametrize("case", sorted(REF_STRUCTS))
def test_thrift_struct_gives_the_reference_results(case):
    buf = REF_STRUCTS[case]
    want, wpos = jpq._thrift_struct(memoryview(buf), 0)
    got, gpos = thr._thrift_struct(memoryview(buf), 0)
    assert gpos == wpos == len(buf)
    # every field the reference decodes (it skips lists, binaries and
    # doubles as None) decodes to the same value
    for k, v in want.items():
        if v is not None:
            assert got[k] == v, k
    assert set(got) == set(want)
    # and skipping the whole struct lands where parsing does
    assert thr._thrift_skip(memoryview(buf), 0, thr.T_STRUCT) == len(buf)


DEFS = [
    (_uvarint(100 << 1) + b"\x01", 100),
    (_uvarint(100 << 1) + b"\x00", 100),
    (_uvarint(2 << 1 | 1) + b"\xff\xff", 16),
    (_uvarint(2 << 1 | 1) + b"\xff\xfe", 16),
    (_uvarint(2 << 1 | 1) + b"\xff\x0f", 12),
    (_uvarint(2 << 1 | 1) + b"\xff\x07", 12),
    (_uvarint(8 << 1) + b"\x01" + _uvarint(1 << 1 | 1) + b"\xff", 16),
    (_uvarint(8 << 1) + b"\x01", 16),
]


@pytest.mark.parametrize("i", range(len(DEFS)))
def test_defs_all_present_run_shapes(i):
    """The reference's hand-built bit-width-1 blocks give the same answer
    in both packages (RLE runs, bit-packed groups, a partial last byte)."""
    buf, n = DEFS[i]
    assert tpq._defs_all_present(buf, n) == jpq._defs_all_present(buf, n)


def test_thrift_decodes_lists_binaries_bytes_doubles():
    fields = [(1, thr.T_BINARY, b"abc"),
              (2, thr.T_LIST, (thr.T_I32, [1, -2, 300])),
              (3, thr.T_LIST, (thr.T_BINARY, [b"x", b"", b"yz"])),
              (4, thr.T_LIST, (thr.T_STRUCT, [[(1, thr.T_I64, 7)],
                                              [(2, thr.T_TRUE, False)]])),
              (5, thr.T_STRUCT, [(1, thr.T_I16, -5)]),
              (40, thr.T_I64, 1 << 40),            # a long-form field id
              (41, thr.T_LIST, (thr.T_I32, list(range(20))))]  # long list
    buf = thr.encode_struct(fields)
    got, pos = thr._thrift_struct(memoryview(buf), 0)
    assert pos == len(buf)
    assert got == {1: b"abc", 2: [1, -2, 300], 3: [b"x", b"", b"yz"],
                   4: [{1: 7}, {2: False}], 5: {1: -5}, 40: 1 << 40,
                   41: list(range(20))}
    # the byte type (IntType.bitWidth), a double and a bool list
    buf = bytes([0x13, 0xF8, 0x17]) + np.float64(2.5).tobytes() \
        + bytes([0x19, 0x21, 0x01, 0x02, 0x00])
    got, pos = thr._thrift_struct(memoryview(buf), 0)
    assert got == {1: -8, 2: 2.5, 3: [True, False]} and pos == len(buf)


CRAFTED = {
    # a list claiming 2^40 i32 elements in 3 bytes
    "huge_list": bytes([0x19, 0xF5]) + _uvarint(1 << 40) + b"\x02\x02\x02",
    # a list of 2^40 bool elements
    "huge_bool_list": bytes([0x19, 0xF1]) + _uvarint(1 << 40) + b"\x01",
    # 0x1C opens a nested struct per byte
    "deep_nesting": bytes([0x1C] * 5000),
    # a list of lists, nested past the limit
    "deep_lists": bytes([0x19] + [0x19] * 200),
    "truncated_binary": bytes([0x18]) + _uvarint(100) + b"abc",
    "truncated_struct": bytes([0x15, 0x02, 0x16]),
    "varint_overflow": bytes([0x15] + [0xFF] * 12 + [0x01]),
    "map_type": bytes([0x1B, 0x00, 0x00]),
}


@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_crafted_bytes_raise_and_do_not_hang(case):
    with pytest.raises((thr.ThriftError, IndexError)):
        thr._thrift_struct(memoryview(CRAFTED[case]), 0)


def _footer_file(tmp_path, body: bytes) -> str:
    p = str(tmp_path / "bad.parquet")
    with open(p, "wb") as f:
        f.write(body)
    return p


@pytest.mark.parametrize("case", ["short", "magic", "length", "garbage",
                                  "deep"])
def test_bad_footers_raise_value_error_naming_the_file(tmp_path, case):
    meta = {"garbage": bytes(range(1, 200)),
            "deep": bytes([0x1C] * 5000)}.get(case, b"\x15\x02\x00")
    body = {"short": b"PAR1PAR1",
            "magic": b"PAR1" + meta + len(meta).to_bytes(4, "little")
            + b"PAR2",
            "length": b"PAR1" + meta + (1 << 30).to_bytes(4, "little")
            + b"PAR1"}.get(case, b"PAR1" + meta + len(meta).to_bytes(
                4, "little") + b"PAR1")
    p = _footer_file(tmp_path, body)
    with pytest.raises(ValueError, match="bad.parquet"):
        tpq.ParquetShard(p)


# ------------------------------------------------------------ footer parity
def _int_json(lt) -> tuple:
    d = json.loads(lt.to_json())
    return d.get("bitWidth"), d.get("isSigned")


@pytest.mark.parametrize("name", sorted(FILES) + ["pages", "nested"])
def test_footer_matches_pyarrow_field_by_field(files, name):
    p, _ = files[name]
    want = pq.read_metadata(p)
    got = tpq.ParquetShard(p).metadata
    for attr in ("num_rows", "num_row_groups", "num_columns",
                 "serialized_size"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for i in range(want.num_columns):
        ws, gs = want.schema.column(i), got.schema.column(i)
        assert gs.path == ws.path
        assert gs.max_definition_level == ws.max_definition_level
        assert gs.max_repetition_level == ws.max_repetition_level
        assert gs.converted_type == ws.converted_type, gs.path
        assert gs.logical_type.type == ws.logical_type.type, gs.path
        if ws.logical_type.type == "INT":
            assert (gs.logical_type.bit_width, gs.logical_type.is_signed) \
                == _int_json(ws.logical_type)
    for g in range(want.num_row_groups):
        for i in range(want.num_columns):
            wc, gc = want.row_group(g).column(i), got.row_group(g).column(i)
            for attr in ("physical_type", "compression", "num_values",
                         "data_page_offset", "dictionary_page_offset",
                         "total_compressed_size", "path_in_schema"):
                assert getattr(gc, attr) == getattr(wc, attr), (g, i, attr)
            ws_, gs_ = wc.statistics, gc.statistics
            lt = want.schema.column(i).logical_type.type
            if lt not in ("NONE", "INT") or ws_ is None:
                # a date, timestamp, ...: the port decodes no statistics
                assert gs_ is None
                continue
            for attr in ("has_min_max", "has_null_count", "null_count"):
                assert getattr(gs_, attr) == getattr(ws_, attr), (g, i, attr)
            if ws_.has_min_max:
                assert (gs_.min, gs_.max) == (ws_.min, ws_.max), (g, i)
                assert type(gs_.min) is type(ws_.min)


# -------------------------------------------------------- statistics parity
@pytest.mark.parametrize("name", ["plain", "plain_nostats", "snappy"])
def test_row_group_stats_match_the_reference(files, name):
    p, _ = files[name]
    tshard, jshard = tpq.ParquetShard(p), jpq.ParquetShard(p)
    for g in range(tshard.num_row_groups):
        got = tpd.row_group_stats(tshard, g, NUMERIC + ("nul",))
        want = jpd.row_group_stats(jshard, g, NUMERIC + ("nul",))
        assert {k: tuple(v) for k, v in got.items()} \
            == {k: tuple(v) for k, v in want.items()}
        # date32: the reference holds datetime.date bounds, the port none
        jd = jpd.row_group_stats(jshard, g, ["d32"])
        assert tpd.row_group_stats(tshard, g, ["d32"]) == {}
        if name != "plain_nostats":
            assert isinstance(jd["d32"].min, datetime.date)
    if name == "plain":
        assert tpd.row_group_stats(tshard, 0, ["u32"])["u32"].max \
            >= 2147483653


OPS = ("<", "<=", ">", ">=", "==", "!=")
LITERALS = (-(1 << 41), -3, -1.5, 0, 0.25, 7, 1 << 19, 2147483653, 1 << 41)


@pytest.mark.parametrize("op", OPS)
def test_predicates_refute_the_same_groups(files, op):
    """Numeric literals over every column (date32 included, where the
    reference's stats raise TypeError against a number and the port has
    none: both pass the group)."""
    for name in ("plain", "plain_nostats"):
        p, _ = files[name]
        tshard, jshard = tpq.ParquetShard(p), jpq.ParquetShard(p)
        cols = NUMERIC + ("d32", "nul")
        for g in range(tshard.num_row_groups):
            tst = tpd.row_group_stats(tshard, g, cols)
            jst = jpd.row_group_stats(jshard, g, cols)
            for c in cols:
                for v in LITERALS:
                    assert tpd.Cmp(c, op, v).refutes(tst) \
                        == jpd.Cmp(c, op, v).refutes(jst), (name, g, c, v)
            both = (tpd.col("i32") > 0) & (tpd.col("f64") < 1.0)
            jboth = (jpd.col("i32") > 0) & (jpd.col("f64") < 1.0)
            assert both.refutes(tst) == jboth.refutes(jst)


def test_predicate_matrix_refutes_something(files):
    """The matrix above is not vacuous: the port refutes groups."""
    p, _ = files["plain"]
    st = tpd.row_group_stats(tpq.ParquetShard(p), 0, ["i32"])
    assert (tpd.col("i32") > 1 << 21).refutes(st)
    assert not (tpd.col("i32") > 0).refutes(st)


# ------------------------------------------------------------ the PLAIN route
COLS = ("i32", "i64", "f32", "f64", "u32", "d32", "nul")


@pytest.mark.parametrize("name", sorted(FILES) + ["pages"])
def test_read_row_group_arrays_match_the_reference(ctxs, files, name):
    """Every column, every group: the port's arrays equal the reference's
    (values and dtype), and the plain and pyarrow counters move by the same
    bytes in both packages."""
    tctx, jctx = ctxs
    p, _ = files[name]
    tshard, jshard = tpq.ParquetShard(p, ctx=tctx), jpq.ParquetShard(
        p, ctx=jctx)
    for cols in (("i32", "i64", "f32", "f64"), COLS):
        for g in range(tshard.num_row_groups):
            t0, j0 = _counts(tctx), _jcounts()
            got = tshard.read_row_group_arrays(tctx, g, list(cols))
            want = jshard.read_row_group_arrays(jctx, g, list(cols))
            t1, j1 = _counts(tctx), _jcounts()
            assert (t1[0] - t0[0], t1[1] - t0[1]) \
                == (j1[0] - j0[0], j1[1] - j0[1]), (cols, g)
            for c in cols:
                assert got[c].dtype == want[c].dtype, c
                np.testing.assert_array_equal(got[c], want[c])
    plain = name in ("plain", "plain_nostats", "pages")
    t0 = _counts(tctx)
    tshard.read_row_group_arrays(tctx, 0, ["f64", "i32"])
    t1 = _counts(tctx)
    assert (t1[0] > t0[0], t1[1] > t0[1]) == (plain, not plain)


def test_single_page_chunk_is_a_view(ctxs, files):
    tctx, _ = ctxs
    p, table = files["plain"]
    shard = tpq.ParquetShard(p, ctx=tctx)
    ci = shard._col_indices(["f64"])[0]
    buf = tctx.pread(shard.column_chunk_extents(0, ["f64"]))
    pages = tpq.decode_plain_pages(shard.metadata.row_group(0).column(ci),
                                   shard.metadata.schema.column(ci), buf)
    assert len(pages) == 1 and np.shares_memory(pages[0], buf)
    np.testing.assert_array_equal(pages[0],
                                  table.slice(0, GROUP)["f64"].to_numpy())


def test_multi_page_chunks_are_page_views(ctxs, files):
    tctx, _ = ctxs
    p, table = files["pages"]
    shard = tpq.ParquetShard(p, ctx=tctx)
    pages = shard.read_row_group_pages(tctx, 0, ["f32", "i64"])
    assert [len(x) for x in pages["f32"]] == [20_000, 10_000]
    for c in ("f32", "i64"):
        np.testing.assert_array_equal(np.concatenate(pages[c]),
                                      table.slice(0, 30_000)[c].to_numpy())


def test_wide_def_levels_fall_back(ctxs, files):
    tctx, jctx = ctxs
    p, _ = files["nested"]
    shard = tpq.ParquetShard(p, ctx=tctx)
    ci = shard._col_indices(["s.v"])[0]
    cs = shard.metadata.schema.column(ci)
    assert cs.max_definition_level == 2
    buf = tctx.pread(shard.column_chunk_extents(0, ["s.v"]))
    # the reference's case has no statistics; here null_count 0 proves it
    st = shard.metadata.row_group(0).column(ci).statistics
    assert st.null_count == 0
    got = shard.read_row_group_arrays(tctx, 0, ["s.v"])["s.v"]
    want = jpq.ParquetShard(p).read_row_group_arrays(jctx, 0, ["s.v"])["s.v"]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(tpq._PlainDecodeUnsupported):
        tpq.decode_plain_pages(
            shard.metadata.row_group(0).column(ci),
            cs, buf[:7])


MALFORMED = [
    lambda good, rng: good[:7],
    lambda good, rng: good[: len(good) // 2],
    lambda good, rng: np.frombuffer(rng.bytes(256), np.uint8),
    lambda good, rng: np.full(5000, 0x1C, dtype=np.uint8),
    lambda good, rng: np.frombuffer(bytes([0x15, 0x00, 0x25, 0x15, 0x2C, 0x15,
                                           0x03, 0x15, 0x00, 0x00, 0x00])
                                    + b"\0" * 64, np.uint8),
    lambda good, rng: np.frombuffer(bytes([0x15, 0x00, 0x15, 0x80, 0x01, 0x15,
                                           0x80, 0x01, 0x2C, 0x15, 0x03, 0x15,
                                           0x00, 0x15, 0x06, 0x00, 0x00])
                                    + b"\0" * 80, np.uint8),
]


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_malformed_chunk_bytes_fall_back_not_crash(ctxs, files, i):
    """The reference's malformed chunks (truncated, garbage, a nesting
    bomb, negative sizes) raise the fallback signal in both packages."""
    tctx, jctx = ctxs
    p, _ = files["pages"]
    tshard = tpq.ParquetShard(p, ctx=tctx)
    jshard = jpq.ParquetShard(p, ctx=jctx)
    ci = tshard._col_indices(["f64"])[0]
    good = tctx.pread(tshard.column_chunk_extents(0, ["f64"]))
    bad = MALFORMED[i](good, np.random.default_rng(i))
    with pytest.raises(tpq._PlainDecodeUnsupported):
        tpq.decode_plain_pages(tshard.metadata.row_group(0).column(ci),
                               tshard.metadata.schema.column(ci), bad)
    with pytest.raises(jpq._PlainDecodeUnsupported):
        jpq.decode_plain_pages(jshard.metadata.row_group(0).column(ci),
                               jshard.metadata.schema.column(ci), bad)


def test_logical_types_fall_back_and_agree(ctxs, files):
    """uint32, date32, timestamp, int8 and a list ride pyarrow in both
    packages, to equal values and dtypes; the uint32 stays unsigned."""
    tctx, jctx = ctxs
    p, _ = files["plain"]
    got = tpq.ParquetShard(p, ctx=tctx).read_row_group_arrays(
        tctx, 0, ["u32", "d32"])
    want = jpq.ParquetShard(p, ctx=jctx).read_row_group_arrays(
        jctx, 0, ["u32", "d32"])
    assert got["u32"][0] == 2147483653 and got["d32"].dtype.kind == "M"
    for c in ("u32", "d32"):
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c])
    p, _ = files["nested"]
    t0 = _counts(tctx)
    got = tpq.ParquetShard(p, ctx=tctx).read_row_group_arrays(
        tctx, 0, ["ts", "s8"])
    assert _counts(tctx)[0] == t0[0]
    want = jpq.ParquetShard(p, ctx=jctx).read_row_group_arrays(
        jctx, 0, ["ts", "s8"])
    for c in ("ts", "s8"):
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c])


def test_column_dtypes(files):
    p, _ = files["plain"]
    shard = tpq.ParquetShard(p)
    assert [shard.column_dtype(c) for c in ("i32", "i64", "f32", "f64",
                                            "u32", "nul")] \
        == [np.dtype(t) for t in ("<i4", "<i8", "<f4", "<f8", "<u4", "<f8")]
    with pytest.raises(TypeError, match="d32"):
        shard.column_dtype("d32")


def test_pyarrow_route_reads_its_footer_from_the_range_cache(ctxs, files):
    """footer_extent covers pyarrow's footer read (serialized_size equals
    pyarrow's): the pyarrow route has no cache misses."""
    tctx, _ = ctxs
    p, table = files["snappy"]
    before = tctx.scope.snapshot().get("parquet_cache_miss_bytes", 0)
    shard = tpq.ParquetShard(p, ctx=tctx)
    t = shard.read_row_group(tctx, 1, ["f32", "i64"])
    assert t.equals(table.slice(GROUP, GROUP).select(["f32", "i64"]))
    assert tctx.scope.snapshot().get("parquet_cache_miss_bytes", 0) == before


# ------------------------------------------------------------------ writer
def _writer_columns(rng, n=45_001):
    return {"seq": np.arange(n, dtype=np.int64),
            "i32": rng.integers(-50, 50, n).astype(np.int32),
            "pos": np.abs(rng.standard_normal(n)).astype(np.float32),
            "f64": rng.standard_normal(n),
            "zero_max": -np.abs(rng.standard_normal(n)).astype(np.float32)}


@pytest.fixture(scope="module")
def written(tmp_path_factory, ctxs):
    """One file from the port's writer and one from pyarrow, same columns
    (a float column whose minimum is 0 and one whose maximum is 0, for the
    signed-zero rule), 2-page row groups and a short last group."""
    td = tmp_path_factory.mktemp("tpqw")
    cols = _writer_columns(np.random.default_rng(7))
    cols["pos"][17] = 0.0
    cols["zero_max"][5] = -0.0
    mine, theirs = str(td / "mine.parquet"), str(td / "theirs.parquet")
    nbytes = tpq.write_parquet(ctxs[0], mine, cols, row_group_rows=30_000)
    pq.write_table(pa.table({k: pa.array(v) for k, v in cols.items()}),
                   theirs, row_group_size=30_000, compression="NONE",
                   use_dictionary=False)
    return cols, mine, theirs, nbytes


def test_writer_output_reads_back_in_pyarrow(written):
    cols, mine, theirs, nbytes = written
    assert nbytes == os.path.getsize(mine)
    got = pq.read_table(mine)
    assert got.equals(pa.table({k: pa.array(v) for k, v in cols.items()}))
    ma, mb = pq.read_metadata(mine), pq.read_metadata(theirs)
    assert ma.num_row_groups == mb.num_row_groups == 2
    for g in range(2):
        for i in range(ma.num_columns):
            a, b = ma.row_group(g).column(i), mb.row_group(g).column(i)
            assert a.num_values == b.num_values
            sa, sb = a.statistics, b.statistics
            assert (sa.has_min_max, sa.null_count) == (True, 0)
            assert (sa.min, sa.max) == (sb.min, sb.max), (g, i)
            assert [np.signbit(x) for x in (sa.min, sa.max)] \
                == [np.signbit(x) for x in (sb.min, sb.max)], (g, i)


def test_writer_output_rides_the_reference_plain_route(ctxs, written):
    _, jctx = ctxs
    cols, mine, _, _ = written
    shard = jpq.ParquetShard(mine, ctx=jctx)
    j0 = _jcounts()
    off = 0
    for g in range(shard.num_row_groups):
        got = shard.read_row_group_arrays(jctx, g, list(cols))
        n = len(got["seq"])
        for c, v in cols.items():
            np.testing.assert_array_equal(got[c], v[off: off + n])
        off += n
    j1 = _jcounts()
    assert off == len(cols["seq"])
    assert j1[0] > j0[0] and j1[1] == j0[1]


def test_writer_statistics_match_in_both_packages(written):
    cols, mine, _, _ = written
    tshard, jshard = tpq.ParquetShard(mine), jpq.ParquetShard(mine)
    for g in range(2):
        got = tpd.row_group_stats(tshard, g, list(cols))
        want = jpd.row_group_stats(jshard, g, list(cols))
        assert {k: tuple(v) for k, v in got.items()} \
            == {k: tuple(v) for k, v in want.items()}
    assert got["seq"] == tpd.ColStats(30_000, len(cols["seq"]) - 1, 0)


def test_writer_file_decodes_on_the_port_plain_route(ctxs, written):
    tctx, _ = ctxs
    cols, mine, _, _ = written
    shard = tpq.ParquetShard(mine, ctx=tctx)
    t0 = _counts(tctx)
    got = shard.read_row_group_arrays(tctx, 1, list(cols))
    t1 = _counts(tctx)
    assert t1[0] > t0[0] and t1[1] == t0[1]
    for c, v in cols.items():
        np.testing.assert_array_equal(got[c], v[30_000:])


@pytest.mark.parametrize("bad", [np.zeros(4, np.uint8), np.zeros(4, bool),
                                 np.zeros((2, 2), np.float32),
                                 np.array(["a", "b"])])
def test_writer_refuses_other_dtypes(ctxs, tmp_path, bad):
    with pytest.raises(TypeError, match="int32, int64, float32"):
        tpq.write_parquet(ctxs[0], str(tmp_path / "x.parquet"), {"x": bad})


def test_writer_compressed_goes_through_pyarrow(ctxs, tmp_path):
    cols = _writer_columns(np.random.default_rng(3), 3000)
    p = str(tmp_path / "z.parquet")
    tpq.write_parquet(ctxs[0], p, cols, compression="snappy")
    assert pq.read_metadata(p).row_group(0).column(0).compression == "SNAPPY"
    assert pq.read_table(p).equals(
        pa.table({k: pa.array(v) for k, v in cols.items()}))


def test_writer_all_nan_chunk_has_no_min_max(ctxs, tmp_path):
    p = str(tmp_path / "nan.parquet")
    tpq.write_parquet(ctxs[0], p, {"x": np.full(10, np.nan)})
    st = pq.read_metadata(p).row_group(0).column(0).statistics
    assert not st.has_min_max and st.null_count == 0
    assert tpq.ParquetShard(p).metadata.row_group(0).column(0) \
        .statistics.has_min_max is False


# -------------------------------------------------------- pyarrow hidden
def test_without_pyarrow_plain_files_open_write_and_scan(tmp_path,
                                                         monkeypatch, files):
    from strom_torch.pipelines import parquet_count_where

    snappy, _ = files["snappy"]
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    assert tpq.pyarrow_version() is None
    rng = np.random.default_rng(9)
    vals = rng.standard_normal(10_000).astype(np.float32)
    p = str(tmp_path / "plain.parquet")
    ctx = StromContext(StromConfig(engine="python"))
    try:
        decoded0 = _counts(ctx)[1]
        tpq.write_parquet(ctx, p, {"value": vals}, row_group_rows=2_500)
        assert tpq.ParquetShard(p, ctx=ctx).num_row_groups == 4
        assert parquet_count_where(ctx, [p], "value", lambda v: v > 0,
                                   devices=["cpu"]) == int((vals > 0).sum())
        assert _counts(ctx)[1] == decoded0
        shard = tpq.ParquetShard(snappy, ctx=ctx)   # the footer: no pyarrow
        assert shard.num_rows == ROWS
        with pytest.raises(RuntimeError, match="needs pyarrow"):
            shard.read_row_group_arrays(ctx, 0, ["f64"])
        with pytest.raises(RuntimeError, match="needs pyarrow"):
            tpq.write_parquet(ctx, str(tmp_path / "z.parquet"),
                              {"value": vals}, compression="zstd")
    finally:
        ctx.close()


# ---------------------------------------------------------------- striped
@pytest.mark.parametrize("writer", ["port", "pyarrow-zstd"])
def test_striped_shard_reads_equal_the_plain_file(ctxs, tmp_path, writer):
    """A shard on a 4-member RAID0 set through a path alias: footer,
    PLAIN chunks (the port's writer) or the pyarrow route (zstd) all
    stripe-decode, equal to the plain file."""
    tctx, _ = ctxs
    cols = _writer_columns(np.random.default_rng(5), 5000)
    plain = str(tmp_path / "plain.parquet")
    if writer == "port":
        tpq.write_parquet(tctx, plain, cols, row_group_rows=1250)
    else:
        pq.write_table(pa.table(cols), plain, row_group_size=1250,
                       compression="zstd")
    members = [str(tmp_path / f"pm{i}.bin") for i in range(4)]
    stripe_file(plain, members, 32768)
    virt = str(tmp_path / "striped.parquet")   # not on disk
    tctx.register_striped(virt, members, 32768, size=os.path.getsize(plain))
    shard = tpq.ParquetShard(virt, ctx=tctx)
    ref = tpq.ParquetShard(plain, ctx=tctx)
    assert shard.num_rows == 5000 and shard.num_row_groups == 4
    for g in range(4):
        got = shard.read_row_group_arrays(tctx, g, ["seq", "f64"])
        want = ref.read_row_group_arrays(tctx, g, ["seq", "f64"])
        for c in ("seq", "f64"):
            np.testing.assert_array_equal(got[c], want[c])
