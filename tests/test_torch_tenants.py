"""Tenants on one context, on the CPU.

- ``register_tenant`` carves the same hot-cache and spill partitions in
  the port as in the JAX package, and registering again changes nothing.
- Three threads drive a ``llama``-, a ``vis``- and a ``pq``-scoped
  pipeline of the port on one context: every batch and count is exact, and
  each tenant's granted bytes show under its own scope.
- ``StromContext()`` builds a scheduler by default; every gather, stream
  and write goes through its grants, ``sched_enabled=False`` puts the
  engine lock back, and both modes read the same bytes.
- A streamed gather releases its grant when it is cancelled in the middle,
  when it finishes, and when its engine fails.
"""

import json
import threading

import numpy as np
import pytest
import torch

from strom.config import StromConfig as RefConfig
from strom.delivery.core import StromContext as RefContext
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.extents import ExtentList
from strom_torch.delivery.shard import Segment
from strom_torch.engine.base import EngineError
from strom_torch.formats.parquet import write_parquet
from strom_torch.formats.predecoded import LABELS_SUFFIX, META_SUFFIX
from strom_torch.formats.rawbin import write_token_shard
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline
from strom_torch.pipelines.parquet_scan import parquet_count_where
from strom_torch.pipelines.vision import make_predecoded_vision_pipeline
from strom_torch.sched.scheduler import IoScheduler

KiB = 1024
MiB = 1024 * KiB


@pytest.mark.parametrize("spill", [0, 8 * MiB])
def test_register_tenant_partitions_equal_reference(tmp_path, spill):
    parts = []
    for cfg_cls, ctx_cls in ((RefConfig, RefContext),
                             (StromConfig, StromContext)):
        ctx = ctx_cls(cfg_cls(engine="python", hot_cache_bytes=4 * MiB,
                              spill_bytes=spill, spill_dir=str(tmp_path)))
        try:
            a = ctx.register_tenant("llama", priority="training",
                                    hot_cache_bytes=MiB)
            ctx.register_tenant("vis", weight=2, hot_cache_bytes=2 * MiB)
            ctx.register_tenant("pq", priority="interactive")
            again = ctx.register_tenant("llama", hot_cache_bytes=3 * MiB)
            assert again is a
            info = ctx.scheduler.tenants_info()["tenants"]
            parts.append((
                ctx.hot_cache.partitions(),
                ctx.spill_tier.partitions() if ctx.spill_tier else None,
                {n: (r["priority"], r["weight"], r["hot_cache_bytes"])
                 for n, r in info.items()}))
        finally:
            ctx.close()
    assert parts[1] == parts[0]
    assert parts[1][0] == {"llama": {"max_bytes": MiB, "bytes": 0},
                           "vis": {"max_bytes": 2 * MiB, "bytes": 0}}


def test_register_tenant_needs_the_scheduler():
    ctx = StromContext(StromConfig(engine="python", sched_enabled=False))
    try:
        assert ctx.scheduler is None
        with pytest.raises(RuntimeError):
            ctx.register_tenant("x")
    finally:
        ctx.close()


def test_context_builds_a_scheduler_by_default():
    assert StromConfig().sched_enabled is True
    ctx = StromContext(StromConfig(engine="python"))
    try:
        assert isinstance(ctx.scheduler, IoScheduler)
        assert ctx.scheduler.exclusive
        assert ctx.stats()["sched"]["sched_tenants"] == 1
    finally:
        ctx.close()


@pytest.mark.parametrize("sched", [True, False])
@pytest.mark.parametrize("engine", ["python", "uring"])
def test_both_modes_read_exact_bytes(tmp_path, sched, engine):
    if engine == "uring":
        from strom_torch.engine.uring_engine import uring_available

        if not uring_available():
            pytest.skip("io_uring refused here")
    rng = np.random.default_rng(1)
    p = str(tmp_path / "f.bin")
    data = rng.integers(0, 256, 3 * MiB + 123, dtype=np.uint8)
    data.tofile(p)
    ctx = StromContext(StromConfig(engine=engine, sched_enabled=sched,
                                   sched_slice_bytes=256 * KiB,
                                   queue_depth=8))
    try:
        np.testing.assert_array_equal(ctx.pread(p, tenant="t"), data)
        out = ctx.memcpy_ssd2gpu(p, device="cpu", tenant="t")
        np.testing.assert_array_equal(out.numpy(), data)
        host = ctx.memcpy_ssd2host(p, offset=7, length=MiB, tenant="t")
        np.testing.assert_array_equal(host, data[7: 7 + MiB])
        w = rng.integers(0, 256, 2 * MiB, dtype=np.uint8)
        q = str(tmp_path / "w.bin")
        assert ctx.pwrite(q, w, tenant="w") == w.nbytes
        np.testing.assert_array_equal(np.fromfile(q, np.uint8), w)
        # 12 extents in reverse file order (nothing coalesces): 12 chunks,
        # one 256 KiB slice, and one grant, each
        el = ExtentList([(p, (11 - i) * 256 * KiB, 256 * KiB)
                         for i in range(12)])
        want = np.concatenate([data[(11 - i) * 256 * KiB:
                                    (12 - i) * 256 * KiB]
                               for i in range(12)])
        np.testing.assert_array_equal(ctx.pread(el, tenant="s"), want)
        if sched:
            st = ctx.scheduler
            assert st.tenant("s").granted_ops == 12
            assert st.tenant("s").granted_bytes == 3 * MiB
            # whole chunks are never split: one grant a contiguous read
            assert st.tenant("t").granted_ops == 3
            assert st.tenant("t").granted_bytes == \
                2 * data.nbytes + MiB
            assert st.tenant("w").granted_bytes == w.nbytes
            assert ctx.stats()["sched"]["sched_active_grants"] == 0
    finally:
        ctx.close()


def _fixtures(tmp_path, ctx):
    """A token shard, a predecoded shard and two PLAIN Parquet shards."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 1 << 15, 64 * 65, dtype=np.int32)
    tok = str(tmp_path / "tok.bin")
    write_token_shard(ctx, tok, toks)
    side = 16
    recs = rng.integers(0, 256, (48, side, side, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, 48, dtype=np.int32)
    pdec = str(tmp_path / "img.bin")
    recs.tofile(pdec)
    np.save(pdec + LABELS_SUFFIX, labels)
    with open(pdec + META_SUFFIX, "w") as f:
        json.dump({"image_size": side, "n": len(recs)}, f)
    pq, vals = [], []
    for i in range(2):
        v = rng.standard_normal(20_000).astype(np.float32)
        path = str(tmp_path / f"pq{i}.parquet")
        write_parquet(ctx, path, {"value": v}, row_group_rows=5_000)
        pq.append(path)
        vals.append(v)
    return (tok, toks.reshape(64, 65)), (pdec, recs, labels), \
        (pq, int(sum((v > 0).sum() for v in vals)))


@pytest.mark.parametrize("spill", [False, True])
def test_three_tenants_on_one_context(tmp_path, spill):
    ctx = StromContext(StromConfig(
        engine="python", queue_depth=8, sched_slice_bytes=64 * KiB,
        hot_cache_bytes=(256 * KiB if spill else 0),
        hot_cache_admit="always", spill_bytes=(8 * MiB if spill else 0),
        spill_dir=str(tmp_path)), scope={"ctx": f"tenants-{spill}"})
    try:
        (tok, rows), (pdec, recs, labels), (pq, want_count) = \
            _fixtures(tmp_path, ctx)
        ctx.register_tenant("llama", priority="training")
        ctx.register_tenant("vis", priority="training")
        ctx.register_tenant("pq", priority="interactive")
        got: dict = {}
        errors: list = []

        def llama():
            pipe = make_llama_pipeline(
                ctx, [tok], batch=4, seq_len=64, device="cpu", seed=3,
                shuffle=False, scope={"pipeline": "llama", "tenant": "llama"})
            try:
                assert pipe.scope.labels["tenant"] == "llama"
                got["llama"] = [next(pipe).numpy().copy() for _ in range(32)]
            finally:
                pipe.close()

        def vis():
            pipe = make_predecoded_vision_pipeline(
                ctx, [pdec], batch=8, image_size=16, device="cpu",
                shuffle=False,
                scope={"pipeline": "resnet", "tenant": "vis"})
            try:
                got["vis"] = [tuple(t.numpy().copy() for t in next(pipe))
                              for _ in range(12)]
            finally:
                pipe.close()

        def pq_scan():
            got["pq"] = [parquet_count_where(
                ctx, pq, "value", lambda v: v > 0, devices=["cpu"],
                scope={"pipeline": "parquet", "tenant": "pq"})
                for _ in range(3)]

        def run(fn):
            try:
                fn()
            except BaseException as e:   # surfaced after the join
                errors.append(e)

        ths = [threading.Thread(target=run, args=(f,))
               for f in (llama, vis, pq_scan)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert not errors, errors
        for i, b in enumerate(got["llama"]):
            np.testing.assert_array_equal(b, rows[(i * 4) % 64:
                                                  (i * 4) % 64 + 4])
        for i, (imgs, lbls) in enumerate(got["vis"]):
            lo = (i * 8) % 48
            np.testing.assert_array_equal(imgs, recs[lo: lo + 8])
            np.testing.assert_array_equal(lbls, labels[lo: lo + 8])
        assert got["pq"] == [want_count] * 3
        sched = ctx.scheduler
        for name in ("llama", "vis", "pq"):
            t = sched.tenant(name)
            snap = t.scope.snapshot()
            assert t.scope.labels == {"ctx": f"tenants-{spill}",
                                      "tenant": name}
            assert snap["sched_granted_bytes"] == t.granted_bytes > 0
            assert snap["sched_granted_ops"] == t.granted_ops > 0
            assert snap["sched_queue_wait_count"] == t.granted_ops
            assert t.active == 0 and not t.queue
        scopes = ctx.scope.parent.scopes_snapshot()
        assert any('tenant="pq"' in k for k in scopes)
        st = ctx.stats()
        assert st["sched"]["sched_tenants"] >= 4
        assert st["sched"]["sched_active_grants"] == 0
        if spill:
            assert st["spill"]["spill_errors"] == 0
    finally:
        ctx.close()


def _scattered(tmp_path, n=64, rec=64 * KiB):
    rng = np.random.default_rng(2)
    p = str(tmp_path / "s.bin")
    data = rng.integers(0, 256, n * rec * 2, dtype=np.uint8)
    data.tofile(p)
    order = rng.permutation(2 * n)[:n]
    segs = [Segment(int(r) * rec, i * rec, rec) for i, r in enumerate(order)]
    want = np.concatenate([data[s.file_offset: s.file_offset + rec]
                           for s in segs])
    return p, segs, want


def test_cancelled_stream_releases_its_grant(tmp_path):
    p, segs, want = _scattered(tmp_path)
    ctx = StromContext(StromConfig(engine="python", queue_depth=4))
    try:
        sched = ctx.scheduler
        dest = np.zeros(want.nbytes, np.uint8)
        g = ctx.stream_segments(p, segs, dest, tenant="vis")
        assert sched.tenant("vis").active == 1
        assert sched.held_by_me() and not sched.engine_idle()
        g.poll(min_completions=1, timeout_s=5.0)
        g.close()                       # cancelled in the middle
        assert sched.tenant("vis").active == 0
        assert not sched.held_by_me() and sched.engine_idle()
        # another tenant gets the engine at once, and reads exact bytes
        done = threading.Event()
        out = {}

        def other():
            d = np.zeros(want.nbytes, np.uint8)
            g2 = ctx.stream_segments(p, segs, d, tenant="pq")
            try:
                while not g2.done:
                    g2.poll(min_completions=1, timeout_s=1.0)
                g2.finish()
            finally:
                g2.close()
            out["d"] = d
            done.set()

        th = threading.Thread(target=other)
        th.start()
        assert done.wait(30.0)
        th.join()
        np.testing.assert_array_equal(out["d"], want)
        assert sched.tenant("pq").granted_bytes == want.nbytes
        assert ctx.stats()["sched"]["sched_active_grants"] == 0
    finally:
        ctx.close()


def test_finished_stream_releases_at_drain(tmp_path):
    p, segs, want = _scattered(tmp_path)
    ctx = StromContext(StromConfig(engine="python"))
    try:
        dest = np.zeros(want.nbytes, np.uint8)
        with ctx.stream_segments(p, segs, dest, tenant="t") as g:
            while not g.done:
                g.poll(min_completions=1, timeout_s=1.0)
            # the last piece retired: the grant is back before finish()
            assert ctx.scheduler.tenant("t").active == 0
            assert g.finish() == want.nbytes
        np.testing.assert_array_equal(dest, want)
    finally:
        ctx.close()


def test_failed_stream_releases_its_grant(tmp_path):
    p, segs, want = _scattered(tmp_path, n=16)
    ctx = StromContext(StromConfig(engine="python", fault_every=3,
                                   io_retries=0))
    try:
        dest = np.zeros(want.nbytes, np.uint8)
        g = ctx.stream_segments(p, segs, dest, tenant="t")
        with pytest.raises(EngineError):
            g.finish()
        g.close()
        assert ctx.scheduler.tenant("t").active == 0
        assert ctx.scheduler.engine_idle()
    finally:
        ctx.close()


def test_stream_without_scheduler_takes_the_engine_lock(tmp_path):
    p, segs, want = _scattered(tmp_path, n=8)
    ctx = StromContext(StromConfig(engine="python", sched_enabled=False))
    try:
        dest = np.zeros(want.nbytes, np.uint8)
        g = ctx.stream_segments(p, segs, dest, tenant="ignored")
        assert ctx._engine_lock.locked()
        g.close()
        assert not ctx._engine_lock.locked()
        with ctx.engine_exclusive():
            assert ctx._engine_lock.locked()
    finally:
        ctx.close()


def test_readahead_reads_as_the_background_tenant(tmp_path):
    rng = np.random.default_rng(9)
    p = str(tmp_path / "r.bin")
    data = rng.integers(0, 256, 2 * MiB, dtype=np.uint8)
    data.tofile(p)
    ctx = StromContext(StromConfig(engine="python", hot_cache_bytes=4 * MiB))
    try:
        ctx.register_tenant("vis", hot_cache_bytes=4 * MiB)
        assert ctx.warm(p, [Segment(0, 0, data.nbytes)],
                        tenant="vis") == data.nbytes
        ra = ctx.scheduler.tenant("readahead")
        assert ra.granted_bytes == data.nbytes
        assert ctx.hot_cache.partitions()["vis"]["bytes"] >= data.nbytes
        np.testing.assert_array_equal(ctx.pread(p), data)
        assert ctx.stats()["cache"]["cache_hit_bytes"] == data.nbytes
    finally:
        ctx.close()


def test_engine_op_latency_lands_in_the_tenant_scope(tmp_path):
    rng = np.random.default_rng(12)
    p = str(tmp_path / "l.bin")
    rng.integers(0, 256, MiB, dtype=np.uint8).tofile(p)
    ctx = StromContext(StromConfig(engine="python"),
                       scope={"ctx": "oplat"})
    try:
        ctx.pread(p, tenant="lat")
        snap = ctx.scheduler.tenant("lat").scope.snapshot()
        assert snap["engine_op_lat_count"] >= MiB // (128 * KiB)
        assert ctx.engine.op_scope is ctx.scope   # restored at release
    finally:
        ctx.close()


def test_llama_pipeline_on_cpu_tensor_types(tmp_path):
    """The scoped Llama loader still yields int32 tensors on the CPU."""
    ctx = StromContext(StromConfig(engine="python"))
    try:
        toks = np.arange(8 * 33, dtype=np.int32)
        p = str(tmp_path / "t.bin")
        write_token_shard(ctx, p, toks)
        pipe = make_llama_pipeline(ctx, [p], batch=2, seq_len=32,
                                   device="cpu", shuffle=False,
                                   scope={"pipeline": "llama", "tenant": "x"})
        try:
            b = next(pipe)
            assert b.dtype == torch.int32 and b.shape == (2, 33)
            assert pipe.scope.labels == {"pipeline": "llama", "tenant": "x"}
            assert ctx.scheduler.tenant("x").granted_bytes > 0
        finally:
            pipe.close()
    finally:
        ctx.close()
