"""The port's async engine tokens and ``StreamingGather`` against the JAX
package's, on the CPU: the same chunk lists through ``submit_vectored`` /
``poll`` / ``drain`` on the preadv pool, the io_uring engine and the
multi-ring engine (2 and 4 rings, a striped source) land the same dest
bytes, count the same ``bytes_done`` and retire the same set of chunks (in
any order: completions are unordered by design). Cancel mid-flight leaves
nothing pending; a closed engine cancels its live tokens; gathered ranges
tile the dest exactly once; a failing engine makes ``finish`` raise on both
sides; a wedged engine raises ``EngineStallError`` instead of hanging."""

import errno

import numpy as np
import pytest

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.delivery.extents import Extent as JExtent
from strom.delivery.extents import ExtentList as JExtentList
from strom.delivery.shard import Segment as JSegment
from strom.engine import make_engine as j_make_engine
from strom.engine.base import EngineError as JEngineError
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.extents import Extent, ExtentList
from strom_torch.delivery.shard import Segment
from strom_torch.engine import make_engine
from strom_torch.engine.base import EngineError, EngineStallError
from strom_torch.engine.raid0 import stripe_file

MiB = 1 << 20
RECORD = 150_528   # one 224×224×3 image
ENGINES = ["python", "uring", "multi2", "multi4"]


def engine_cfg(engine: str, **kw) -> dict:
    """Config fields of an engine name; skips where no ring can be made."""
    if engine != "python":
        from strom_torch.engine import uring_engine

        if not uring_engine.uring_available():
            pytest.skip(f"io_uring unavailable: {uring_engine.unavailable_reason}")
    base = dict(dict(queue_depth=8, num_buffers=8), **kw)
    if engine.startswith("multi"):
        return dict(base, engine="uring", engine_rings=int(engine[5:]))
    return dict(base, engine=engine)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four 2 MiB + tail seeded files: [(path, bytes)]."""
    d = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(7)
    out = []
    for i in range(4):
        data = rng.integers(0, 256, 2 * MiB + 1000 * i + 77, dtype=np.uint8)
        path = str(d / f"f{i}.bin")
        data.tofile(path)
        out.append((path, data))
    return out


def chunk_plan(files, n: int = 40, seed: int = 0):
    """n seeded (file, offset, length) reads over the four files, some a
    block or more long, laid out back to back in the dest."""
    rng = np.random.default_rng(seed)
    plan, do = [], 0
    for _ in range(n):
        f = int(rng.integers(0, len(files)))
        size = len(files[f][1])
        ln = int(rng.integers(1, 300_000))
        fo = int(rng.integers(0, size - ln))
        plan.append((f, fo, do, ln))
        do += ln
    want = np.concatenate([files[f][1][fo: fo + ln] for f, fo, _, ln in plan])
    return plan, want


def run_token(eng, files, plan, total, **kw):
    """One token driven to its end: (dest, bytes_done, completed indices,
    failed indices, drain's return)."""
    fis = [eng.register_file(p) for p, _ in files]
    chunks = [(fis[f], fo, do, ln) for f, fo, do, ln in plan]
    dest = np.zeros(total, np.uint8)
    tok = eng.submit_vectored(chunks, dest, **kw)
    done, failed = [], []
    while not tok.done:
        for c in eng.poll(tok, min_completions=1, timeout_s=1.0):
            (done if c.result >= 0 else failed).append(c.index)
    n = eng.drain(tok)
    return dest, tok.bytes_done, done, failed, n


@pytest.mark.parametrize("engine", ENGINES)
def test_token_parity(files, engine):
    plan, want = chunk_plan(files)
    teng = make_engine(StromConfig(**engine_cfg(engine)))
    jeng = j_make_engine(JConfig(**engine_cfg(engine)))
    try:
        assert teng.name == jeng.name
        t = run_token(teng, files, plan, want.size)
        j = run_token(jeng, files, plan, want.size)
    finally:
        teng.close()
        jeng.close()
    np.testing.assert_array_equal(t[0], want)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1] == j[1] == t[4] == j[4] == want.size
    assert sorted(t[2]) == sorted(j[2]) == list(range(len(plan)))
    assert t[3] == j[3] == []


@pytest.mark.parametrize("engine", ["python", "uring"])
def test_token_parity_fail_fast_off(files, engine):
    """fail_fast=False with one chunk past EOF: that chunk retires with
    -ENODATA, every other chunk still lands, on both sides; drain raises."""
    plan, want = chunk_plan(files, seed=4)
    f, _, do, ln = plan[5]
    plan[5] = (f, len(files[f][1]) - ln // 2, do, ln)   # half past EOF
    results = []
    for make, cfgcls, errcls in ((make_engine, StromConfig, EngineError),
                                 (j_make_engine, JConfig, JEngineError)):
        eng = make(cfgcls(**engine_cfg(engine)))
        try:
            fis = [eng.register_file(p) for p, _ in files]
            dest = np.zeros(want.size, np.uint8)
            tok = eng.submit_vectored([(fis[f], fo, do, ln)
                                       for f, fo, do, ln in plan], dest,
                                      fail_fast=False)
            seen = {}
            while not tok.done:
                for c in eng.poll(tok, min_completions=1, timeout_s=1.0):
                    seen[c.index] = c.result
            with pytest.raises(errcls) as ei:
                eng.drain(tok)
            assert ei.value.errno == errno.ENODATA
            results.append((dest, seen))
        finally:
            eng.close()
    (tdest, tseen), (jdest, jseen) = results
    assert tseen == jseen
    assert tseen[5] == -errno.ENODATA and len(tseen) == len(plan)
    ok = np.ones(want.size, bool)
    ok[do: do + ln] = False
    np.testing.assert_array_equal(tdest[ok], want[ok])
    np.testing.assert_array_equal(tdest[ok], jdest[ok])


@pytest.mark.parametrize("engine", ["python", "uring"])
def test_short_read_drains_then_raises(files, engine):
    """A chunk past EOF: drain raises ENODATA on both sides, only after
    every piece retired; the in-range chunk still landed."""
    path, data = files[0]
    size = len(data)
    plan = [(0, 0, 0, 4096), (0, size - 100, 4096, 4096)]
    for make, cfgcls, err in ((make_engine, StromConfig, EngineError),
                              (j_make_engine, JConfig, JEngineError)):
        eng = make(cfgcls(**engine_cfg(engine)))
        try:
            fi = eng.register_file(path)
            dest = np.zeros(8192, np.uint8)
            tok = eng.submit_vectored([(fi, fo, do, ln)
                                       for _, fo, do, ln in plan], dest)
            with pytest.raises(err) as ei:
                eng.drain(tok)
            assert ei.value.errno == errno.ENODATA
            assert not tok._pending and eng.in_flight() == 0
            np.testing.assert_array_equal(dest[:4096], data[:4096])
        finally:
            eng.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_cancel_mid_flight(files, engine):
    """cancel after the first completion: no piece pending, nothing in
    flight, and the engine serves the next gather exactly."""
    plan, want = chunk_plan(files, seed=1)
    eng = make_engine(StromConfig(**engine_cfg(engine, queue_depth=4)))
    try:
        fis = [eng.register_file(p) for p, _ in files]
        chunks = [(fis[f], fo, do, ln) for f, fo, do, ln in plan]
        tok = eng.submit_vectored(chunks, np.zeros(want.size, np.uint8))
        eng.poll(tok, min_completions=1)
        eng.cancel(tok)
        assert tok.cancelled and tok.done
        assert not tok._pending and eng.in_flight() == 0
        with pytest.raises(EngineError) as ei:
            eng.poll(tok)
        assert ei.value.errno == errno.ECANCELED
        dest = np.zeros(want.size, np.uint8)
        assert eng.drain(eng.submit_vectored(chunks, dest)) == want.size
        np.testing.assert_array_equal(dest, want)
        dest2 = np.zeros(want.size, np.uint8)
        assert eng.read_vectored(chunks, dest2) == want.size
        np.testing.assert_array_equal(dest2, want)
    finally:
        eng.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_closed_engine_cancels_live_tokens(files, engine):
    plan, want = chunk_plan(files, seed=2)
    eng = make_engine(StromConfig(**engine_cfg(engine, queue_depth=4)))
    fis = [eng.register_file(p) for p, _ in files]
    tok = eng.submit_vectored([(fis[f], fo, do, ln) for f, fo, do, ln in plan],
                              np.zeros(want.size, np.uint8))
    eng.close()
    assert tok.cancelled and tok.done and not tok._pending
    with pytest.raises(EngineError) as ei:
        eng.poll(tok)
    assert ei.value.errno == errno.ECANCELED


def _extents(files, n=64, seed=3):
    """n seeded 150,528-byte records of the four files, scattered: the port's
    and the JAX package's ExtentList, and the expected bytes."""
    rng = np.random.default_rng(seed)
    picks = []
    for _ in range(n):
        f = int(rng.integers(0, len(files)))
        r = int(rng.integers(0, len(files[f][1]) // RECORD))
        picks.append((files[f][0], r * RECORD, RECORD))
    want = np.concatenate([files[[p for p, _ in files].index(p)][1][o: o + n]
                           for p, o, n in picks])
    return (ExtentList([Extent(*e) for e in picks]),
            JExtentList([JExtent(*e) for e in picks]), want)


def drive(g, total: int) -> tuple[np.ndarray, int]:
    """Poll a gather to its end: (how often each dest byte was reported,
    poll calls)."""
    cover = np.zeros(total, np.int32)
    polls = 0
    while not g.done:
        for lo, hi in g.poll(min_completions=1, timeout_s=0.5):
            cover[lo:hi] += 1
        polls += 1
    return cover, polls


@pytest.mark.parametrize("engine", ENGINES)
def test_streaming_gather_matches_reference(files, engine):
    """Ranges tile the dest exactly once; the dest equals the file bytes
    and the reference's dest; finish counts the bytes."""
    el, jel, want = _extents(files)
    tctx = StromContext(StromConfig(**engine_cfg(engine)))
    jctx = JContext(JConfig(**engine_cfg(engine)))
    try:
        gathers0 = tctx.stats(["stream"])["stream"]["stream_gathers"]
        dest = np.zeros(el.size, np.uint8)
        g = tctx.stream_segments(el, [Segment(0, 0, el.size)], dest)
        cover, _ = drive(g, el.size)
        assert g.finish() == el.size and g.finish() == el.size
        assert (cover == 1).all()
        assert 0 < g.inflight_peak <= 8 * tctx.config.engine_rings
        jdest = np.zeros(jel.size, np.uint8)
        jg = jctx.stream_segments(jel, [JSegment(0, 0, jel.size)], jdest)
        while not jg.done:
            jg.poll(min_completions=1, timeout_s=0.5)
        jg.finish()
        np.testing.assert_array_equal(dest, want)
        np.testing.assert_array_equal(dest, jdest)
        assert tctx.stats()["stream"]["stream_gathers"] - gathers0 == 1
    finally:
        tctx.close()
        jctx.close()


@pytest.mark.parametrize("rings", [2, 4])
def test_striped_streaming_gather_matches_reference(files, tmp_path, rings):
    """A striped alias over 4 members under the multi-ring engine: the
    gather fans out over every ring and equals the reference's."""
    engine_cfg("uring")
    path, data = files[0]
    members = [str(tmp_path / f"m{i}.bin") for i in range(4)]
    chunk = 64 * 1024
    stripe_file(path, members, chunk)
    segs = [(5, 300_000), (700_001, 1_000_000), (0, 1)]   # (offset, length)
    want = np.concatenate([data[o: o + n] for o, n in segs])
    dests = []
    for ctxcls, cfgcls, segcls in ((StromContext, StromConfig, Segment),
                                   (JContext, JConfig, JSegment)):
        ctx = ctxcls(cfgcls(**engine_cfg(f"multi{rings}")))
        try:
            ctx.register_striped("alias.bin", members, chunk, size=len(data))
            dest = np.zeros(want.size, np.uint8)
            pos, segments = 0, []
            for o, n in segs:
                segments.append(segcls(o, pos, n))
                pos += n
            g = ctx.stream_segments("alias.bin", segments, dest)
            if ctxcls is StromContext:
                cover, _ = drive(g, want.size)
                assert (cover == 1).all()
                ring_bytes = [r["bytes_read"] for r in
                              ctx.stats()["engine"]["ring_stats"]]
                assert all(b > 0 for b in ring_bytes), ring_bytes
            else:
                while not g.done:
                    g.poll(min_completions=1, timeout_s=0.5)
            g.finish()
            dests.append(dest)
        finally:
            ctx.close()
    np.testing.assert_array_equal(dests[0], want)
    np.testing.assert_array_equal(dests[0], dests[1])


@pytest.mark.parametrize("engine", ["python", "uring", "multi2"])
def test_close_mid_flight_then_exact_gather(files, engine):
    """close() mid-flight is idempotent, leaves nothing in flight and
    frees the engine: the next gather on the context is exact."""
    el, _, want = _extents(files, seed=5)
    ctx = StromContext(StromConfig(**engine_cfg(engine, queue_depth=4)))
    try:
        g = ctx.stream_segments(el, [Segment(0, 0, el.size)],
                                np.zeros(el.size, np.uint8))
        g.poll(min_completions=1)
        g.close()
        g.close()
        assert g.poll() == [] and ctx.engine.in_flight() == 0
        dest = np.zeros(el.size, np.uint8)
        with ctx.stream_segments(el, [Segment(0, 0, el.size)], dest) as g3:
            cover, _ = drive(g3, el.size)
            g3.finish()
        assert (cover == 1).all()
        np.testing.assert_array_equal(dest, want)
        np.testing.assert_array_equal(ctx.pread(el), want)
    finally:
        ctx.close()


@pytest.mark.parametrize("engine", ["python", "uring"])
def test_fault_every_makes_both_finish_raise(files, engine):
    """Every read fails (fault_every=1, retries spent): both finish() calls
    raise EngineError after every piece retired."""
    el, jel, _ = _extents(files, n=8)
    for ctxcls, cfgcls, segcls, errcls in (
            (StromContext, StromConfig, Segment, EngineError),
            (JContext, JConfig, JSegment, JEngineError)):
        ctx = ctxcls(cfgcls(**engine_cfg(engine, fault_every=1)))
        try:
            src = el if ctxcls is StromContext else jel
            g = ctx.stream_segments(src, [segcls(0, 0, src.size)],
                                    np.zeros(src.size, np.uint8))
            with pytest.raises(errcls) as ei:
                while not g.done:
                    g.poll(min_completions=1, timeout_s=0.5)
                g.finish()
            assert ei.value.errno == errno.EIO
            assert ctx.engine.in_flight() == 0
            g.close()
        finally:
            ctx.close()


def test_stalled_engine_raises_instead_of_hanging(files):
    """An engine whose completions never come: the gather's watchdog raises
    EngineStallError naming the stuck ops after engine_wait_timeout_s, and
    close() afterwards does not hang."""
    el, _, _ = _extents(files, n=4)
    ctx = StromContext(StromConfig(engine="python", queue_depth=4,
                                   engine_wait_timeout_s=0.3))
    real_wait = ctx.engine.wait
    ctx.engine.wait = lambda min_completions=1, timeout_s=None: []
    try:
        g = ctx.stream_segments(el, [Segment(0, 0, el.size)],
                                np.zeros(el.size, np.uint8))
        with pytest.raises(EngineStallError) as ei:
            while not g.done:
                g.poll(min_completions=1, timeout_s=0.05)
        assert ei.value.errno == errno.ETIMEDOUT and ei.value.stuck_tags
        ctx.engine.wait = real_wait
        g.close()
        assert ctx.engine.in_flight() == 0
    finally:
        ctx.engine.wait = real_wait
        ctx.close()


def test_pread_and_empty_gather(files, tmp_path):
    path, data = files[1]
    ctx = StromContext(StromConfig(engine="python"))
    try:
        np.testing.assert_array_equal(ctx.pread(path, 1000, 5000),
                                      data[1000:6000])
        np.testing.assert_array_equal(ctx.pread(path), data)
        assert ctx.pread(path, 5, 0).size == 0
        g = ctx.stream_segments(ExtentList([]), [], np.zeros(1, np.uint8))
        assert g.done and g.poll() == [] and g.finish() == 0
        g.close()
    finally:
        ctx.close()
    with pytest.raises(RuntimeError, match="closed"):
        ctx.pread(path)
