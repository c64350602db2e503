"""What the vision and Llama pipelines tell the observability plane, held
to the JAX package on the CPU with the same files on both sides:

- each vision batch build is one "batch" request owned by its context, the
  streamed pump re-entering it, and each ``__next__`` one owned "step"
  request: with two live contexts, the idle one's SLO engine sees no
  tenant, and no ownerless "gather" request is minted;
- the prefetcher mirrors ``prefetch_depth`` and
  ``prefetch_data_stall_steps`` into the pipeline's scope, so the
  Prometheus text and ``stats(sections=["scopes"])`` carry the same
  prefetch series as the reference's;
- the decode counters two 8-image batches move (the ``decode_batch``
  histogram, ``decode_put_overlap_ms``, ``stream_first_decode_lat``,
  ``decode_slot_bytes``, ``decode_roi_rows_skipped``), streamed and not;
- two row groups decoded with the first group's put overlapping the
  second's decode: ``decode_put_overlap_ms`` grows and one
  ``decode.put_overlap`` instant is written, in both packages."""

import collections
import concurrent.futures
import re
import time

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import strom
import strom_torch
from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.formats.jpeg import DecodePool as JDecodePool
from strom.obs import request as j_request
from strom.obs.events import ring as j_ring
from strom.parallel.mesh import make_mesh
from strom.pipelines import make_llama_pipeline as j_make_llama
from strom.pipelines import vision as jvision
from strom.utils.stats import global_stats as j_stats
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.formats.jpeg import DecodePool
from strom_torch.obs import request as t_request
from strom_torch.obs.events import ring as t_ring
from strom_torch.pipelines import make_llama_pipeline
from strom_torch.pipelines import vision as tvision
from strom_torch.utils.stats import global_stats as t_stats
from tests.test_formats import make_wds_shard

cv2 = pytest.importorskip("cv2")

BATCH, SIZE = 8, 32


@pytest.fixture(scope="module")
def tar(tmp_path_factory):
    """24 seeded noise JPEGs of 96×112 with ASCII class labels."""
    rng = np.random.default_rng(8)
    samples = []
    for i in range(24):
        img = rng.integers(0, 256, (96, 112, 3), dtype=np.uint8)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        samples.append((f"s{i:04d}", {"jpg": buf.tobytes(),
                                      "cls": str(i % 10).encode()}))
    path = str(tmp_path_factory.mktemp("wds") / "shard.tar")
    make_wds_shard(path, samples)
    return path


def _sharding(rank: int = 4):
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return NamedSharding(mesh, JP("dp", *([None] * (rank - 1))))


class _Side:
    """One package's constructors, so a test body runs on both."""

    def __init__(self, port: bool):
        self.port = port
        self.Config = StromConfig if port else JConfig
        self.Context = StromContext if port else JContext
        self.request = t_request if port else j_request
        self.stats = t_stats if port else j_stats
        self.vision = tvision if port else jvision
        self.prometheus = strom_torch.prometheus if port else strom.prometheus

    def where(self, rank: int = 4) -> dict:
        return {"device": "cpu"} if self.port \
            else {"sharding": _sharding(rank)}

    def wds(self, ctx, tar, **kw):
        return self.vision.make_wds_vision_pipeline(
            ctx, [tar], batch=BATCH, image_size=SIZE, seed=3,
            decode_workers=2, **self.where(), **kw)

    def llama(self, ctx, paths, **kw):
        make = make_llama_pipeline if self.port else j_make_llama
        return make(ctx, paths, **self.where(2), **kw)


@pytest.mark.parametrize("stream", [True, False])
def test_vision_batches_are_owned_requests(tar, stream):
    """Two contexts, A running 3 batches of a tenant-scoped vision
    pipeline and B idle: B's SLO sees no tenant, and every request minted
    is A's, "batch" or "step", in both packages."""
    kinds = {}
    for port in (True, False):
        side = _Side(port)
        a = side.Context(side.Config(engine="python"))
        b = side.Context(side.Config(engine="python"))
        seen: list = []

        def observe(req, seen=seen):
            seen.append((req.kind, req.owner))

        side.request.add_observer(observe)
        try:
            with side.wds(a, tar, scope={"tenant": "vis"},
                          stream_intra_batch=stream) as pipe:
                for _ in range(3):
                    next(pipe)
        finally:
            side.request.remove_observer(observe)
        try:
            assert b._slo.tenants() == [], port
            assert {owner is a._req_owner for _, owner in seen} == {True}, \
                (port, seen)
            count = collections.Counter(k for k, _ in seen)
            assert set(count) == {"batch", "step"}, (port, count)
            assert count["step"] == 3 and count["batch"] >= 3, (port, count)
            kinds[port] = set(count)
        finally:
            a.close()
            b.close()
    assert kinds[True] == kinds[False]


def _next_ready(pipe):
    """The next batch once every prefetched batch is ready: no stall, so
    the stall gauge reads the same in both packages."""
    concurrent.futures.wait(list(pipe._prefetcher._queue))
    return next(pipe)


_PREFETCH = re.compile(r'^strom_prefetch_\w+(\{pipeline="llama"\})? ')


def _prefetch_lines(text: str) -> list[str]:
    return sorted(ln for ln in text.splitlines() if _PREFETCH.match(ln))


def test_prefetch_gauges_reach_prometheus_and_scopes(tmp_path):
    """40 records of 65 int32 tokens, a Llama pipeline of depth 2 run for
    3 batches: the prefetch series of both packages' Prometheus text and
    their scopes section agree, the depth 2 and 0 stalls."""
    rng = np.random.default_rng(4)
    path = str(tmp_path / "tokens.bin")
    rng.integers(0, 512, (40, 65), dtype=np.int32).tofile(path)
    got = {}
    for port in (True, False):
        side = _Side(port)
        ctx = side.Context(side.Config(engine="python"))
        try:
            with side.llama(ctx, [path], batch=4, seq_len=64,
                            prefetch_depth=2) as pipe:
                for _ in range(3):
                    _next_ready(pipe)
                assert pipe.data_stall_steps == 0
                scope = ctx.stats(sections=["scopes"])["scopes"][
                    'pipeline="llama"']
                got[port] = (_prefetch_lines(side.prometheus()),
                             {k: v for k, v in scope.items()
                              if k.startswith("prefetch_")})
        finally:
            ctx.close()
    assert got[True] == got[False]
    lines, scope = got[True]
    assert 'strom_prefetch_depth{pipeline="llama"} 2' in lines
    assert "strom_prefetch_depth 2" in lines
    assert 'strom_prefetch_data_stall_steps{pipeline="llama"} 0' in lines
    assert "strom_prefetch_data_stall_steps 0" in lines
    assert scope == {"prefetch_depth": 2, "prefetch_data_stall_steps": 0}


_DECODE_KEYS = (("decode", "decode_batch_count"),
                ("decode", "decode_put_overlap_ms"),
                ("decode", "decode_slot_bytes"),
                ("decode", "decode_roi_rows_skipped"),
                ("stream", "stream_first_decode_lat_count"))


@pytest.mark.parametrize("stream", [True, False])
def test_two_batches_move_the_decode_counters(tar, stream):
    """Two 8-image batches on one device group (the one consumed and the
    one prefetched at depth 1, read once it is ready): the same growth of
    the decode counters in both packages (a decode_batch observation and
    the slot's bytes a batch, the rows the ROI decode skipped; a
    first-decode latency a batch only when streamed; no put overlap with a
    single group)."""
    deltas = {}
    for port in (True, False):
        side = _Side(port)
        ctx = side.Context(side.Config(engine="python"))
        try:
            before = ctx.stats(sections=["decode", "stream"])
            with side.wds(ctx, tar, prefetch_depth=1, decode_native=True,
                          decode_roi=True, stream_intra_batch=stream) as pipe:
                _next_ready(pipe)
                concurrent.futures.wait(list(pipe._prefetcher._queue))
                after = ctx.stats(sections=["decode", "stream"])
        finally:
            ctx.close()
        deltas[port] = {k: after[s][k] - before[s][k]
                        for s, k in _DECODE_KEYS}
    assert deltas[True] == deltas[False]
    d = deltas[True]
    assert d["decode_batch_count"] == 2
    assert d["decode_slot_bytes"] == 2 * BATCH * SIZE * SIZE * 3
    assert d["decode_put_overlap_ms"] == 0
    assert d["decode_roi_rows_skipped"] > 0
    assert d["stream_first_decode_lat_count"] == (2 if stream else 0)


def _slow_transform(delay_rows: set):
    """A transform that fills its row with the row's first byte, sleeping
    0.2 s first for the rows in *delay_rows*."""
    def tf(data, rng, out=None):
        row = int(data[0])
        if row in delay_rows:
            time.sleep(0.2)
        out[...] = row
        return out

    return tf


@pytest.mark.parametrize("port", [True, False], ids=["port", "reference"])
def test_overlapped_groups_note_the_put_overlap(port):
    """Rows 0-1 are group 0, rows 2-3 group 1, whose rows decode 0.2 s
    late: group 0's put fires while group 1 still decodes, so
    ``decode_put_overlap_ms`` grows by about 200 and one
    ``decode.put_overlap`` instant is written."""
    side = _Side(port)
    images = np.zeros((4, 2, 2, 3), np.uint8)
    blobs = [np.array([r], np.uint8) for r in range(4)]
    rngs = [None] * 4
    row_pos = {r: r for r in range(4)}
    tf = _slow_transform({2, 3})
    ring = t_ring if port else j_ring
    n0 = side.stats.counter("decode_put_overlap_ms").value
    c0 = side.stats.histogram("decode_batch").count
    t0 = ring.now_us()
    pool = (DecodePool if port else JDecodePool)(4, fuse_runs=False)
    try:
        if port:
            puts = []
            shards = tvision._decode_put_overlapped(
                pool, tf, blobs, rngs, images,
                [("cpu", (0, 2)), ("cpu", (2, 4))], row_pos,
                lambda di, rows: puts.append(di) or rows.copy(),
                side.stats)
            assert puts == [0, 1]
        else:
            devs = jax.devices()[:2]
            ctx = JContext(JConfig(engine="python"))
            try:
                shards = [np.asarray(s) for s in jvision._decode_put_overlapped(
                    ctx, pool, tf, blobs, rngs, images,
                    [(devs[0], (0, 2)), (devs[1], (2, 4))], row_pos,
                    scope=side.stats)]
            finally:
                ctx.close()
    finally:
        pool.close()
    np.testing.assert_array_equal(np.concatenate(shards),
                                  np.arange(4, dtype=np.uint8)[:, None, None,
                                                               None]
                                  * np.ones((1, 2, 2, 3), np.uint8))
    grew = side.stats.counter("decode_put_overlap_ms").value - n0
    assert 100 <= grew <= 2000, grew
    assert side.stats.histogram("decode_batch").count == c0 + 1
    instants = [e for e in ring.snapshot()
                if e.get("name") == "decode.put_overlap" and e["ts_us"] >= t0]
    assert len(instants) == 1
