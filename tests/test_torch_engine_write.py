"""The port's engine write path against the JAX package's, on the CPU:
``submit_vectored(op="write")`` and ``write_vectored`` on every engine of
the port (the preadv pool, the io_uring engine and the multi-ring engine
where a ring can be made, and a multi-ring engine over preadv children),
the cases of ``tests/test_engine_write.py``. A file the port writes from a
chunk list equals, byte for byte, the one the JAX package's engine writes
from the same list."""

import errno
import os
import threading

import numpy as np
import pytest

from strom.config import StromConfig as JConfig
from strom.engine.python_engine import PythonEngine as JPythonEngine
from strom_torch.config import StromConfig
from strom_torch.engine import uring_engine as ue
from strom_torch.engine.base import Completion, EngineError
from strom_torch.engine.python_engine import PythonEngine

MiB = 1024 * 1024


def _cfg() -> StromConfig:
    return StromConfig(queue_depth=8, num_buffers=16)


@pytest.fixture(params=["python", "uring", "multi", "multi2", "py_multi"])
def any_engine(request, monkeypatch):
    if request.param == "python":
        eng = PythonEngine(_cfg())
    elif request.param == "py_multi":
        # the fan-out state machine over preadv children
        from strom_torch.engine import multi

        monkeypatch.setattr(multi, "UringEngine",
                            lambda config, **kw: PythonEngine(config))
        eng = multi.MultiRingEngine(StromConfig(queue_depth=8, num_buffers=16,
                                                engine_rings=2))
    else:
        if not ue.uring_available():
            pytest.skip(f"io_uring unavailable: {ue.unavailable_reason}")
        if request.param == "uring":
            eng = ue.UringEngine(_cfg())
        else:
            from strom_torch.engine.multi import MultiRingEngine

            eng = MultiRingEngine(StromConfig(
                queue_depth=8, num_buffers=16,
                engine_rings=2 if request.param == "multi2" else 1))
    yield eng
    eng.close()


def _mk_file(path, nbytes: int = 0) -> str:
    fd = os.open(str(path), os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if nbytes:
            os.ftruncate(fd, nbytes)
    finally:
        os.close(fd)
    return str(path)


@pytest.fixture()
def rng():
    return np.random.default_rng(13)


def test_integrity_and_exactly_once_accounting(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "w.bin")
    fi = any_engine.register_file(p, writable=True)
    data = rng.integers(0, 256, 4 * MiB, dtype=np.uint8)
    per = len(data) // 16
    chunks = [(fi, i * per, i * per, per) for i in range(16)]
    tok = any_engine.submit_vectored(chunks, data, op="write")
    seen = []
    while not tok.done:
        for c in any_engine.poll(tok, min_completions=1):
            assert c.result == per
            seen.append(c.index)
    assert sorted(seen) == list(range(16))
    assert any_engine.drain(tok) == len(data)
    assert any_engine.in_flight() == 0
    np.testing.assert_array_equal(np.fromfile(p, dtype=np.uint8), data)
    # per ring on a multi-ring engine (its children count the ops)
    st = [e.stats() for e in getattr(any_engine, "_children", [any_engine])]
    assert sum(s["bytes_written"] for s in st) == len(data)
    assert sum(s["ops_written"] for s in st) == len(data) // (128 * 1024)


def test_write_then_read_back_through_the_engine(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "rt.bin")
    fi = any_engine.register_file(p, writable=True)
    data = rng.integers(0, 256, 2 * MiB, dtype=np.uint8)
    assert any_engine.write_vectored([(fi, 0, 0, len(data))],
                                     data) == len(data)
    dest = np.zeros(len(data), dtype=np.uint8)
    assert any_engine.read_vectored([(fi, 0, 0, len(data))],
                                    dest) == len(data)
    np.testing.assert_array_equal(dest, data)


def test_unaligned_offset_falls_back_buffered(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "u.bin", 4096)
    fi = any_engine.register_file(p, writable=True)
    data = rng.integers(0, 256, 1000, dtype=np.uint8)
    assert any_engine.write_vectored([(fi, 7, 0, 1000)], data) == 1000
    back = np.fromfile(p, dtype=np.uint8)
    np.testing.assert_array_equal(back[7:1007], data)
    assert not back[:7].any() and not back[1007:].any()


def test_multi_piece_chunks_complete_once(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "mp.bin")
    fi = any_engine.register_file(p, writable=True)
    ln = 1 * MiB   # 8 block-size pieces
    data = rng.integers(0, 256, 2 * ln, dtype=np.uint8)
    tok = any_engine.submit_vectored([(fi, 0, 0, ln), (fi, ln, ln, ln)], data,
                                     op="write")
    seen = []
    while not tok.done:
        seen.extend(any_engine.poll(tok, min_completions=1))
    assert sorted(c.index for c in seen) == [0, 1]
    assert all(c.result == ln for c in seen)
    assert any_engine.drain(tok) == 2 * ln
    np.testing.assert_array_equal(np.fromfile(p, dtype=np.uint8), data)


def test_sequential_write_read_cycles(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "cyc.bin")
    fi = any_engine.register_file(p, writable=True)
    for _ in range(3):
        data = rng.integers(0, 256, 1 * MiB, dtype=np.uint8)
        assert any_engine.write_vectored([(fi, 0, 0, len(data))],
                                         data) == len(data)
        dest = np.zeros(len(data), dtype=np.uint8)
        any_engine.read_vectored([(fi, 0, 0, len(data))], dest)
        np.testing.assert_array_equal(dest, data)
    assert any_engine.in_flight() == 0


def test_write_to_readonly_registration_raises(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "ro.bin", 1 * MiB)
    fi = any_engine.register_file(p)   # not writable
    data = rng.integers(0, 256, 64 * 1024, dtype=np.uint8)
    with pytest.raises(EngineError):
        any_engine.write_vectored([(fi, 0, 0, len(data))], data, retries=0)
    assert not np.fromfile(p, dtype=np.uint8).any()


def test_a_read_only_source_buffer_writes(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "rb.bin")
    fi = any_engine.register_file(p, writable=True)
    data = np.frombuffer(rng.bytes(256 * 1024), dtype=np.uint8)
    assert not data.flags["WRITEABLE"]
    assert any_engine.write_vectored([(fi, 0, 0, len(data))],
                                     data) == len(data)
    np.testing.assert_array_equal(np.fromfile(p, dtype=np.uint8), data)


def test_cancel_reaps_everything(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "c.bin")
    fi = any_engine.register_file(p, writable=True)
    data = rng.integers(0, 256, 4 * MiB, dtype=np.uint8)
    per = len(data) // 16
    tok = any_engine.submit_vectored([(fi, i * per, i * per, per)
                                      for i in range(16)], data, op="write")
    any_engine.cancel(tok)
    assert tok.cancelled
    assert any_engine.in_flight() == 0
    with pytest.raises(EngineError):
        any_engine.poll(tok)


def test_close_cancels_live_write_token(any_engine, tmp_path, rng):
    p = _mk_file(tmp_path / "cl.bin")
    fi = any_engine.register_file(p, writable=True)
    data = rng.integers(0, 256, 4 * MiB, dtype=np.uint8)
    per = len(data) // 16
    tok = any_engine.submit_vectored([(fi, i * per, i * per, per)
                                      for i in range(16)], data, op="write")
    t = threading.Thread(target=any_engine.close)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "close() hung on a live write token"
    assert tok.cancelled


def test_bad_op_raises(any_engine, tmp_path):
    fi = any_engine.register_file(_mk_file(tmp_path / "x.bin"),
                                  writable=True)
    with pytest.raises(ValueError, match="op must be"):
        any_engine.submit_vectored([(fi, 0, 0, 8)], np.zeros(8, np.uint8),
                                   op="append")


@pytest.mark.parametrize("shape", ["contiguous", "scattered", "unaligned"])
def test_same_file_as_the_reference_engine(tmp_path, rng, shape):
    """The same chunk list out of the same buffer, written by the port's
    preadv pool and by the JAX package's: byte-equal files."""
    data = rng.integers(0, 256, 3 * MiB + 777, dtype=np.uint8)
    if shape == "contiguous":
        chunks = [(0, 0, 0, len(data))]
    elif shape == "scattered":
        order = rng.permutation(12)
        per = MiB // 4
        chunks = [(0, int(i) * per, int(k) * per, per)
                  for k, i in enumerate(order)]
    else:
        chunks = [(0, 5, 3, 100_000), (0, 200_003, 100_003, 1 * MiB),
                  (0, 4096 * 700, 2 * MiB, 777)]
    files = []
    for label, eng in (("port", PythonEngine(_cfg())),
                       ("ref", JPythonEngine(JConfig(queue_depth=8,
                                                     num_buffers=16)))):
        p = _mk_file(tmp_path / f"{label}.bin")
        try:
            fi = eng.register_file(p, writable=True)
            ch = [(fi, fo, do, ln) for (_, fo, do, ln) in chunks]
            assert eng.write_vectored(ch, data) == sum(c[3] for c in ch)
        finally:
            eng.close()
        files.append(open(p, "rb").read())
    assert files[0] == files[1] and len(files[0]) > 0


def test_python_engine_counts_each_route(tmp_path, rng):
    """Aligned pieces take the O_DIRECT fd where the file allows it, an
    unaligned one the buffered fd (counted as an unaligned fallback)."""
    eng = PythonEngine(_cfg())
    try:
        p = _mk_file(tmp_path / "r.bin")
        fi = eng.register_file(p, writable=True)
        from strom_torch.delivery.buffers import alloc_aligned

        src = alloc_aligned(MiB + 100)
        src[:] = rng.integers(0, 256, len(src), dtype=np.uint8)
        eng.write_vectored([(fi, 0, 0, len(src))], src)
        st = eng.stats()
        pieces = 9   # 8 aligned 128 KiB pieces and a 100-byte tail
        assert st["direct_writes"] + st["buffered_writes"] == pieces
        if eng.file_uses_o_direct(fi):
            assert st["direct_writes"] == 8
            assert st["unaligned_fallback_writes"] == 1
        else:
            assert st["buffered_writes"] == pieces
        assert st["bytes_written"] == len(src)
        np.testing.assert_array_equal(np.fromfile(p, dtype=np.uint8), src)
    finally:
        eng.close()


class _Flaky(PythonEngine):
    """Its first *times* writes fail: short (half the piece lands, half
    reported) or with *err*."""

    def __init__(self, config, kind: str, times: int, err=errno.EIO):
        super().__init__(config)
        self._kind, self._left, self._err = kind, times, err
        self._flaky_lock = threading.Lock()
        self.injected = 0

    def _write(self, req, f, view, direct):
        with self._flaky_lock:
            fire = self._left > 0
            self._left -= fire
            self.injected += fire
        if not fire:
            return super()._write(req, f, view, direct)
        if self._kind == "short":
            n = req.length // 2
            os.pwritev(f.fd_buffered, [view[:n]], req.offset)
            self._done_q.put(Completion(req.tag, n))
        else:
            self._done_q.put(Completion(req.tag, -self._err))


@pytest.mark.parametrize("kind", ["short", "errno"])
def test_failed_writes_retry_to_the_full_bytes(tmp_path, rng, kind):
    """A short write or a transient errno is retried, the whole piece
    rewritten, and the full bytes land; a short write counts no bytes."""
    eng = _Flaky(_cfg(), kind, times=2)
    try:
        p = _mk_file(tmp_path / f"{kind}.bin")
        fi = eng.register_file(p, writable=True)
        data = rng.integers(0, 256, 1 * MiB, dtype=np.uint8)
        assert eng.write_vectored([(fi, 0, 0, len(data))], data,
                                  retries=2) == len(data)
        np.testing.assert_array_equal(np.fromfile(p, dtype=np.uint8), data)
        assert eng.injected == 2
        assert eng.stats()["bytes_written"] == len(data)
    finally:
        eng.close()


@pytest.mark.parametrize("kind", ["short", "errno"])
def test_failed_writes_raise_once_retries_are_spent(tmp_path, rng, kind):
    eng = _Flaky(_cfg(), kind, times=100)
    try:
        fi = eng.register_file(_mk_file(tmp_path / "f.bin"), writable=True)
        data = rng.integers(0, 256, 256 * 1024, dtype=np.uint8)
        with pytest.raises(EngineError, match="short write|write failed"):
            eng.write_vectored([(fi, 0, 0, len(data))], data, retries=1)
        assert eng.in_flight() == 0
    finally:
        eng.close()


@pytest.mark.parametrize("writer", ["token_shard", "parquet"])
def test_writers_go_through_pwrite_and_drop_cached_bytes(tmp_path, writer):
    """write_token_shard and write_parquet write through ctx.pwrite: the
    bytes count in host2ssd_bytes, and a hot-cache entry of the path,
    admitted before a rewrite, no longer serves the old bytes after it."""
    from strom_torch.delivery.core import StromContext
    from strom_torch.formats.parquet import ParquetShard, write_parquet
    from strom_torch.formats.rawbin import write_token_shard

    path = str(tmp_path / f"f.{writer}")
    ctx = StromContext(StromConfig(engine="python", hot_cache_bytes=8 * MiB,
                                   hot_cache_admit="always"))

    def write(seed: int) -> int:
        vals = np.random.default_rng(seed).integers(0, 1 << 20, 50_000,
                                                    dtype=np.int32)
        if writer == "token_shard":
            return write_token_shard(ctx, path, vals)
        return write_parquet(ctx, path, {"v": vals.astype(np.float32)},
                             row_group_rows=10_000)

    try:
        w0 = ctx.stats()["context"]["host2ssd_bytes"]
        n = write(1)
        assert ctx.stats()["context"]["host2ssd_bytes"] - w0 == n
        first = ctx.pread(path).copy()
        ctx.pread(path)
        assert ctx.stats()["cache"]["cache_entries"] > 0
        n2 = write(2)
        st = ctx.stats()
        assert st["context"]["host2ssd_bytes"] - w0 == n + n2
        assert st["cache"]["cache_entries"] == 0
        second = ctx.pread(path)
        assert second.nbytes == n2 == os.path.getsize(path)
        assert not np.array_equal(second[:4096], first[:4096])
        np.testing.assert_array_equal(second, np.fromfile(path, np.uint8))
        if writer == "parquet":
            assert ParquetShard(path, ctx=ctx).num_row_groups == 5
    finally:
        ctx.close()
