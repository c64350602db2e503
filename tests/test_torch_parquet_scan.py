"""The port's Parquet scan on ``devices=["cpu"]`` against the JAX package's
on the same files: counts exactly; float64 sums against numpy at rtol
1e-12 (the port keeps float64); the JAX package's sums at its own stated
tolerance (rtol 1e-4, atol 1e-3: it sums float32 in JAX's default 32-bit
mode). Then the pushdown counters against the reference's, ``reduce`` and
``decode_workers``, a multi-process group (which must raise), and the
OpGraph on the port's WebDataset pipeline, fused and not, against the JAX
pipeline's batches."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.ops.pushdown import PUSHDOWN_FIELDS
from strom.ops.pushdown import col as jcol
from strom.pipelines import parquet_count_where as j_count_where
from strom.pipelines import parquet_scan_aggregate as j_scan
from strom.utils.stats import global_stats
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.formats.parquet import write_parquet
from strom_torch.ops.pushdown import col
from strom_torch.pipelines import parquet_count_where, parquet_scan_aggregate

CPU = ["cpu"]
J_TOL = dict(rtol=1e-4, atol=1e-3)   # the reference's float32 sums


@pytest.fixture(scope="module")
def ctxs():
    t = StromContext(StromConfig(engine="python", queue_depth=8,
                                 num_buffers=8))
    j = JContext(JConfig(engine="python", queue_depth=8, num_buffers=8))
    yield t, j
    t.close()
    j.close()


@pytest.fixture(scope="module")
def pq_shards(tmp_path_factory):
    """The reference's fixture: 3 pyarrow shards (snappy, dictionary) of
    4 row groups of (id int64, value float64)."""
    rng = np.random.default_rng(31)
    td = tmp_path_factory.mktemp("tpqs")
    paths, frames = [], []
    for s in range(3):
        n = 4000
        vals = rng.normal(size=n)
        table = pa.table({"id": pa.array(np.arange(n, dtype=np.int64)),
                          "value": pa.array(vals)})
        p = str(td / f"part{s}.parquet")
        pq.write_table(table, p, row_group_size=1000)
        paths.append(p)
        frames.append(vals)
    return paths, np.concatenate(frames)


def _sum_n(cols):
    v = cols["value"]
    return {"sum": v.sum(), "n": torch.ones_like(v, dtype=torch.int32).sum()}


def _j_sum_n(cols):
    v = cols["value"]
    return {"sum": jnp.sum(v), "n": jnp.asarray(v.shape[0], jnp.int32)}


# ------------------------------------------------------------------ the scan
def test_count_where_matches_numpy_and_the_reference(ctxs, pq_shards):
    tctx, jctx = ctxs
    paths, vals = pq_shards
    got = parquet_count_where(tctx, paths, "value", lambda v: v > 0.5,
                              devices=CPU)
    want = j_count_where(jctx, paths, "value", lambda v: v > 0.5)
    assert got == want == int((vals > 0.5).sum())


@pytest.mark.parametrize("unit_batch", [2, 5, 100])
def test_unit_batch_identical_results(ctxs, pq_shards, unit_batch):
    tctx, jctx = ctxs
    paths, vals = pq_shards
    got = parquet_count_where(tctx, paths, "value", lambda v: v > 0.5,
                              unit_batch=unit_batch, devices=CPU)
    want = j_count_where(jctx, paths, "value", lambda v: v > 0.5,
                         unit_batch=unit_batch)
    assert got == want == int((vals > 0.5).sum())
    out = parquet_scan_aggregate(tctx, paths, ["value"], _sum_n,
                                 unit_batch=unit_batch, devices=CPU)
    assert out["n"] == len(vals)
    np.testing.assert_allclose(out["sum"], vals.sum(), rtol=1e-12)


@pytest.mark.parametrize("unit_batch", [0, -1])
def test_unit_batch_rejects_nonpositive(ctxs, pq_shards, unit_batch):
    tctx, jctx = ctxs
    paths, _ = pq_shards
    with pytest.raises(ValueError, match="unit_batch"):
        parquet_count_where(tctx, paths, "value", lambda v: v > 0,
                            unit_batch=unit_batch, devices=CPU)
    with pytest.raises(ValueError, match="unit_batch"):
        j_count_where(jctx, paths, "value", lambda v: v > 0,
                      unit_batch=unit_batch)


def test_zero_units_contributes_zero(ctxs, pq_shards):
    """Process 12 of 13 draws none of the 12 units: a zero aggregate of the
    same structure, in the column's dtype."""
    tctx, jctx = ctxs
    paths, _ = pq_shards
    got = parquet_scan_aggregate(tctx, paths, ["value"], _sum_n,
                                 process_index=12, process_count=13,
                                 devices=CPU)
    want = j_scan(jctx, paths, ["value"], _j_sum_n, process_index=12,
                  process_count=13, reduce="allgather")
    assert set(got) == set(want) == {"sum", "n"}
    assert got["sum"] == want["sum"] == 0.0 and got["n"] == want["n"] == 0
    # torch sums integers in int64
    assert got["sum"].dtype == np.float64 and got["n"].dtype == np.int64


def test_round_robin_partition_sums_to_whole(ctxs, pq_shards):
    """A simulated 3-process scan: each partition equals the reference's
    partition, and the partitions sum to the whole."""
    tctx, jctx = ctxs
    paths, vals = pq_shards
    parts = [parquet_scan_aggregate(tctx, paths, ["value"], _sum_n,
                                    process_index=i, process_count=3,
                                    devices=CPU) for i in range(3)]
    jparts = [j_scan(jctx, paths, ["value"], _j_sum_n, process_index=i,
                     process_count=3, reduce="allgather") for i in range(3)]
    for p, jp in zip(parts, jparts):
        assert p["n"] == jp["n"] == 4000
        np.testing.assert_allclose(p["sum"], jp["sum"], **J_TOL)
    assert sum(p["n"] for p in parts) == len(vals)
    np.testing.assert_allclose(sum(p["sum"] for p in parts), vals.sum(),
                               rtol=1e-12)


def test_aggregate_sum_matches(ctxs, pq_shards):
    tctx, jctx = ctxs
    paths, vals = pq_shards
    out = parquet_scan_aggregate(tctx, paths, ["value"], _sum_n, devices=CPU)
    want = j_scan(jctx, paths, ["value"], _j_sum_n, reduce="allgather")
    assert out["n"] == want["n"] == len(vals)
    np.testing.assert_allclose(out["sum"], vals.sum(), rtol=1e-12)
    np.testing.assert_allclose(want["sum"], vals.sum(), **J_TOL)


def test_map_fn_sees_each_column_in_its_own_dtype(ctxs, pq_shards):
    tctx, _ = ctxs
    paths, _ = pq_shards
    seen = []

    def map_fn(cols):
        seen.append({c: (t.dtype, t.device.type) for c, t in cols.items()})
        return cols["id"].sum()

    out = parquet_scan_aggregate(tctx, paths, ["value", "id"], map_fn,
                                 devices=CPU)
    assert out == 3 * sum(range(4000))
    assert seen and all(s == {"value": (torch.float64, "cpu"),
                              "id": (torch.int64, "cpu")} for s in seen)


def test_wide_projection_scan(ctxs, tmp_path):
    """The reference bench's WIDE shape: every selected column reaches the
    aggregate; per-column sums at float64 against numpy."""
    tctx, jctx = ctxs
    rng = np.random.default_rng(23)
    cols = {f"f{i}": rng.standard_normal(4_000) for i in range(4)}
    path = str(tmp_path / "wide.parquet")
    pq.write_table(pa.table(cols), path, row_group_size=1_000)
    names = list(cols)
    out = parquet_scan_aggregate(tctx, [path], names,
                                 lambda d: {c: d[c].sum() for c in names},
                                 unit_batch=2, devices=CPU)
    want = j_scan(jctx, [path], names,
                  lambda d: {c: jnp.sum(d[c]) for c in names}, unit_batch=2,
                  reduce="allgather")
    for c in names:
        np.testing.assert_allclose(out[c], cols[c].sum(), rtol=1e-12)
        np.testing.assert_allclose(want[c], cols[c].sum(), **J_TOL)


@pytest.mark.parametrize("writer", ["pyarrow", "port"])
def test_plain_encoded_scan_rides_direct_decoder(ctxs, tmp_path, writer):
    """An uncompressed PLAIN file (pyarrow's, or the port's writer): the
    count is exact and every selected byte went through the direct decoder
    in both packages, by the same bytes."""
    tctx, jctx = ctxs
    rng = np.random.default_rng(29)
    vals = rng.standard_normal(12_000).astype(np.float32)
    path = str(tmp_path / "plain.parquet")
    if writer == "port":
        write_parquet(tctx, path, {"value": vals}, row_group_rows=3_000)
    else:
        pq.write_table(pa.table({"value": vals}), path, row_group_size=3_000,
                       compression="NONE", use_dictionary=False)
    t0, j0 = tctx.stats(), global_stats.snapshot()
    got = parquet_count_where(tctx, [path], "value", lambda v: v > 0,
                              unit_batch=2, devices=CPU)
    want = j_count_where(jctx, [path], "value", lambda v: v > 0,
                         unit_batch=2)
    t1, j1 = tctx.stats(), global_stats.snapshot()
    assert got == want == int((vals > 0).sum())

    def delta(a, b, k):
        return b.get(k, 0) - a.get(k, 0)

    plain = delta(t0, t1, "parquet_plain_bytes")
    assert vals.nbytes <= plain < vals.nbytes + 4096
    assert plain == delta(j0, j1, "parquet_plain_bytes")
    assert delta(t0, t1, "parquet_decode_bytes") == 0
    assert delta(j0, j1, "parquet_decode_bytes") == 0
    assert delta(t0, t1, "parquet_scan_units") == 4


@pytest.mark.parametrize("reduce", ["collective", "allgather", "bogus"])
def test_reduce_validation(ctxs, pq_shards, reduce):
    tctx, jctx = ctxs
    paths, vals = pq_shards
    if reduce == "bogus":
        with pytest.raises(ValueError, match="reduce"):
            parquet_scan_aggregate(tctx, paths, ["value"], _sum_n,
                                   reduce=reduce, devices=CPU)
        with pytest.raises(ValueError, match="reduce"):
            j_scan(jctx, paths, ["value"], _j_sum_n, reduce=reduce)
        return
    out = parquet_scan_aggregate(tctx, paths, ["value"], _sum_n,
                                 reduce=reduce, devices=CPU)
    np.testing.assert_allclose(out["sum"], vals.sum(), rtol=1e-12)


def test_decode_workers_one_and_four_equal(ctxs, pq_shards):
    tctx, _ = ctxs
    paths, _ = pq_shards

    def map_fn(cols):
        return {"sum": cols["value"].sum(), "ids": cols["id"].sum()}

    a, b = (parquet_scan_aggregate(tctx, paths, ["value", "id"], map_fn,
                                   unit_batch=3, decode_workers=w,
                                   devices=CPU) for w in (1, 4))
    assert a["ids"] == b["ids"]
    assert a["sum"].tobytes() == b["sum"].tobytes()


def test_process_group_above_one_raises(ctxs, pq_shards, monkeypatch):
    """No silent partial sum: with torch.distributed initialised at a world
    size of 2 the scan refuses to run."""
    tctx, _ = ctxs
    paths, _ = pq_shards
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        parquet_scan_aggregate(tctx, paths, ["value"], _sum_n, devices=CPU)


def test_date_columns_refuse_before_reading(ctxs, tmp_path):
    tctx, _ = ctxs
    p = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"d": pa.array(np.arange(10, dtype=np.int32),
                                           type=pa.date32())}), p)
    with pytest.raises(TypeError, match="not numeric"):
        parquet_scan_aggregate(tctx, [p], ["d"], lambda c: c["d"].sum(),
                               devices=CPU)


# -------------------------------------------------------------- pushdown
class TestParquetPushdown:
    ROWS, GROUPS = 4000, 8

    def _write(self, tmp_path, name, **kw):
        rng = np.random.default_rng(3)
        path = str(tmp_path / name)
        # monotone seq: disjoint per-group min/max, so a cutoff refutes a
        # controlled set of groups
        pq.write_table(pa.table({
            "seq": np.arange(self.ROWS, dtype=np.int64),
            "value": rng.integers(0, 1000, self.ROWS, dtype=np.int64),
        }), path, row_group_size=self.ROWS // self.GROUPS, **kw)
        return path

    def _scan_pair(self, ctx, path, cutoff):
        """(pushed, post-hoc) integer aggregates of the port."""

        def m_push(d):
            return {"hits": (d["value"] > 500).sum(), "ssum": d["seq"].sum()}

        def m_post(d):
            keep = d["seq"] < cutoff
            return {"hits": ((d["value"] > 500) & keep).sum(),
                    "ssum": torch.where(keep, d["seq"], 0).sum()}

        pushed = parquet_scan_aggregate(ctx, [path], ["value", "seq"],
                                        m_push, predicate=col("seq") < cutoff,
                                        devices=CPU)
        post = parquet_scan_aggregate(ctx, [path], ["value", "seq"], m_post,
                                      devices=CPU)
        return ({k: int(v) for k, v in pushed.items()},
                {k: int(v) for k, v in post.items()})

    def _j_pushed(self, ctx, path, cutoff):
        def m_push(d):
            return {"hits": jnp.sum((d["value"] > 500).astype(jnp.int32)),
                    "ssum": jnp.sum(d["seq"].astype(jnp.int32))}

        out = j_scan(ctx, [path], ["value", "seq"], m_push,
                     predicate=jcol("seq") < cutoff, reduce="allgather")
        return {k: int(v) for k, v in out.items()}

    def _both(self, ctxs, path, cutoff):
        """The port's pushed and post-hoc results and pushdown counters,
        and the reference's pushed result and counters."""
        tctx, jctx = ctxs
        t0 = tctx.stats()
        pushed, post = self._scan_pair(tctx, path, cutoff)
        t1 = tctx.stats()
        j0 = global_stats.snapshot()
        jpushed = self._j_pushed(jctx, path, cutoff)
        j1 = global_stats.snapshot()
        d = {k: t1.get(k, 0) - t0.get(k, 0) for k in PUSHDOWN_FIELDS}
        jd = {k: j1.get(k, 0) - j0.get(k, 0) for k in PUSHDOWN_FIELDS}
        return pushed, post, jpushed, d, jd

    def test_pushdown_bit_identical_and_skips(self, ctxs, tmp_path):
        path = self._write(tmp_path, "push.parquet")
        # 750 straddles group 1 (rows 500..999): the row mask as well as
        # whole-group refutation of groups 2..7
        pushed, post, jpushed, d, jd = self._both(ctxs, path, 750)
        assert pushed == post == jpushed
        assert d == jd
        assert d["parquet_pushdown_groups_total"] == self.GROUPS
        assert d["parquet_pushdown_groups_skipped"] == 6
        assert d["parquet_pushdown_skipped_bytes"] > 0
        assert d["parquet_pushdown_rows_masked"] == 250

    def test_missing_stats_groups_conservatively_pass(self, ctxs, tmp_path):
        path = self._write(tmp_path, "nostats.parquet",
                           write_statistics=False)
        pushed, post, jpushed, d, jd = self._both(ctxs, path, 750)
        assert pushed == post == jpushed
        assert d == jd
        assert d["parquet_pushdown_groups_skipped"] == 0
        assert d["parquet_pushdown_skipped_bytes"] == 0

    def test_all_groups_refuted_yields_zero(self, ctxs, tmp_path):
        path = self._write(tmp_path, "allout.parquet")
        pushed, post, jpushed, d, jd = self._both(ctxs, path, -1)
        assert pushed == post == jpushed == {"hits": 0, "ssum": 0}
        assert d == jd
        assert d["parquet_pushdown_groups_skipped"] == self.GROUPS


# --------------------------------------------------------------- OpGraph
def test_opgraph_fused_matches_unfused_and_the_reference(tmp_path):
    """The port's WebDataset pipeline with the reference test's graph
    (filter, project, normalize, cast): fused and streamed, unfused, and
    fused and unstreamed give bit-equal float32 batches of the graph's
    shape, equal to the JAX pipeline's with the same graph, seed and
    files; the ops_* counters move in the context's stats."""
    cv2 = pytest.importorskip("cv2")
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from strom.ops import OpGraph as JOpGraph
    from strom.parallel.mesh import make_mesh
    from strom.pipelines.vision import make_wds_vision_pipeline as j_wds
    from strom_torch.ops.pushdown import OpGraph
    from strom_torch.pipelines.vision import make_wds_vision_pipeline
    from tests.test_formats import make_wds_shard

    rng = np.random.default_rng(5)
    samples = []
    for i in range(24):
        img = rng.integers(0, 256, (48 + (i % 5), 56, 3), dtype=np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        assert ok
        samples.append((f"s{i:04d}", {"jpg": buf.tobytes(),
                                      "cls": str(i % 10).encode()}))
    path = str(tmp_path / "og.tar")
    make_wds_shard(path, samples)

    def graph(cls):
        return (cls()
                .filter(lambda x: x[0, 0, 0] < 250)
                .project(slice(0, 24), slice(0, 24))
                .normalize([127.5] * 3, [63.0] * 3)
                .cast(np.float32))

    kw = dict(engine="python", queue_depth=8, num_buffers=16,
              hot_cache_bytes=64 * 1024 * 1024, hot_cache_admit="always")

    def run(fuse, stream):
        ctx = StromContext(StromConfig(**kw))
        try:
            with make_wds_vision_pipeline(
                    ctx, [path], batch=8, image_size=32, device="cpu",
                    seed=11, decode_workers=2, stream_intra_batch=stream,
                    opgraph=graph(OpGraph), opgraph_fuse=fuse) as pipe:
                out = [tuple(t.numpy().copy() for t in next(pipe))
                       for _ in range(pipe.sampler.batches_per_epoch * 2)]
            return out, ctx.stats()
        finally:
            ctx.close()

    fused, stats = run(True, True)
    unfused, _ = run(False, False)
    fused_nostream, _ = run(True, False)
    assert fused[0][0].shape == (8, 24, 24, 3)
    assert fused[0][0].dtype == np.float32
    for (ia, la), (ib, lb), (ic, _lc) in zip(fused, unfused, fused_nostream):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ia, ic)
        np.testing.assert_array_equal(la, lb)
    for k in ("ops_graph_samples", "ops_graph_runs", "ops_normalize_samples"):
        assert stats.get(k, 0) > 0, k
    # the prefetcher builds batches ahead of the ones consumed
    assert stats["ops_graph_samples"] >= 8 * len(fused)
    assert stats["ops_graph_samples"] == 8 * stats["ops_graph_runs"]

    jctx = JContext(JConfig(**kw))
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    try:
        with j_wds(jctx, [path], batch=8, image_size=32,
                   sharding=NamedSharding(mesh, P("dp", None, None, None)),
                   seed=11, decode_workers=2, opgraph=graph(JOpGraph)) as pipe:
            want = [tuple(np.asarray(t) for t in next(pipe))
                    for _ in range(len(fused))]
    finally:
        jctx.close()
    for (ia, la), (ja, jl) in zip(fused, want):
        np.testing.assert_array_equal(ia, ja)
        np.testing.assert_array_equal(la, jl)


def test_leaves_of_mixed_sizes_come_back(ctxs, pq_shards):
    """An aggregate tree of leaves of every size, in an order that puts an
    8-byte leaf after a 4-byte one and a 1-byte one (the one host copy
    packs them at 16-byte boundaries), and a tensor of several elements."""
    tctx, _ = ctxs
    paths, vals = pq_shards

    def map_fn(c):
        v = c["value"]
        return {"n32": (v > 0).to(torch.int32).sum(dtype=torch.int32),
                "f32": v.float().sum(), "f64": v.sum(),
                "any": (v > 3).any(), "i64": c["id"].sum(),
                "hist": [torch.histc(v.float(), bins=5, min=-2, max=2),
                         (v.abs() < 1).sum()]}

    out = parquet_scan_aggregate(tctx, paths, ["value", "id"], map_fn,
                                 devices=CPU)
    assert out["n32"] == int((vals > 0).sum()) and out["n32"].dtype == np.int32
    np.testing.assert_allclose(out["f64"], vals.sum(), rtol=1e-12)
    np.testing.assert_allclose(out["f32"], vals.sum(), rtol=1e-4, atol=1e-3)
    assert out["any"] == (vals > 3).any()
    assert out["i64"] == 3 * sum(range(4000))
    hist, _ = np.histogram(vals[(vals >= -2) & (vals <= 2)], bins=5,
                           range=(-2, 2))
    np.testing.assert_array_equal(out["hist"][0], hist)
    assert out["hist"][1] == int((np.abs(vals) < 1).sum())
