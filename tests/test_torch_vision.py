"""The PyTorch port's vision path against the JAX package's on the CPU, the
same seed and files on both sides: WebDataset indexes, JPEG header parsing
(baseline and progressive members), ``predecode_wds`` output files, the
predecoded pipeline's batches and labels, and ``make_wds_vision_pipeline``'s
batches bit for bit, with the native libjpeg-turbo route and with
``decode_native=False`` (cv2). The port's streamed and barrier paths give
bit-identical batches; a failing engine fails the batch; a 0-byte member
does not hang the streamed path."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.formats import jpeg as jjpeg
from strom.formats.predecoded import predecode_wds as j_predecode_wds
from strom.formats.wds import WdsShardSet as JWdsShardSet
from strom.parallel.mesh import make_mesh
from strom.pipelines.vision import \
    make_predecoded_vision_pipeline as j_make_predecoded
from strom.pipelines.vision import make_wds_vision_pipeline as j_make_wds
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.engine.base import EngineError
from strom_torch.formats import jpeg as tjpeg
from strom_torch.formats.predecoded import (LABELS_SUFFIX, META_SUFFIX,
                                            PredecodedShardSet, predecode_wds,
                                            stage_striped_predecoded)
from strom_torch.formats.wds import WdsShardSet
from strom_torch.pipelines import (make_imagenet_resnet_pipeline,
                                   make_predecoded_vision_pipeline,
                                   make_wds_vision_pipeline)
from tests.test_formats import make_wds_shard

cv2 = pytest.importorskip("cv2")

N_SAMPLES, BATCH, SIZE = 24, 8, 32


def _encode(img: np.ndarray, progressive: bool = False) -> bytes:
    flags = [cv2.IMWRITE_JPEG_QUALITY, 90]
    if progressive:
        flags += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def wds_tar(tmp_path_factory):
    """24 seeded noise JPEGs of varying sizes (every sixth progressive) with
    ASCII class labels, in one tar."""
    rng = np.random.default_rng(5)
    samples = []
    for i in range(N_SAMPLES):
        img = rng.integers(0, 256, (96 + 7 * (i % 5), 112 + 3 * (i % 4), 3),
                           dtype=np.uint8)
        samples.append((f"s{i:04d}", {"jpg": _encode(img, i % 6 == 5),
                                      "cls": str(i % 10).encode()}))
    path = str(tmp_path_factory.mktemp("wds") / "shard.tar")
    make_wds_shard(path, samples)
    return path


@pytest.fixture(scope="module")
def sharding1():
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return NamedSharding(mesh, P("dp", None, None, None))


def _engine_kw(engine: str) -> dict:
    """Config fields of an engine: python, uring or multi (2 rings); skips
    where the kernel refuses a ring."""
    if engine != "python":
        from strom_torch.engine import uring_engine

        if not uring_engine.uring_available():
            pytest.skip(f"io_uring unavailable: {uring_engine.unavailable_reason}")
    kw = dict(num_buffers=8)
    if engine == "multi":
        return dict(kw, engine="uring", engine_rings=2)
    return dict(kw, engine=engine)


def _port_batches(path, n, engine="python", cfg=None, **kw):
    """n batches of the port's pipeline on the CPU, and its stats; *cfg*
    adds config fields to the engine's."""
    cfg = dict(dict(queue_depth=8, **_engine_kw(engine)), **(cfg or {}))
    ctx = StromContext(StromConfig(**cfg))
    try:
        with make_wds_vision_pipeline(ctx, [path], batch=BATCH,
                                      image_size=SIZE, device="cpu", seed=11,
                                      decode_workers=2, **kw) as pipe:
            out = [tuple(t.numpy().copy() for t in next(pipe))
                   for _ in range(n)]
            return out, pipe.stats()
    finally:
        ctx.close()


def _ref_batches(path, sharding, n, engine="python", **kw):
    ctx = JContext(JConfig(queue_depth=8, **_engine_kw(engine)))
    try:
        with j_make_wds(ctx, [path], batch=BATCH, image_size=SIZE,
                        sharding=sharding, seed=11, decode_workers=2,
                        **kw) as pipe:
            return [tuple(np.asarray(a) for a in next(pipe))
                    for _ in range(n)]
    finally:
        ctx.close()


def test_wds_indexes_agree(wds_tar, tmp_path):
    """Members, sample grouping and batch gather plans, on a fresh index
    and on the sidecar-cached one."""
    ref = JWdsShardSet([wds_tar], cache_index=False)
    for cache in (False, True, True):
        port = WdsShardSet([wds_tar], cache_index=cache)
        assert [(m.name, m.offset, m.size) for m in port.indexes[0].members] \
            == [(m.name, m.offset, m.size) for m in ref.indexes[0].members]
        assert [(s.key, sorted(s.members)) for s in port] \
            == [(s.key, sorted(s.members)) for s in ref]
        idx = [5, 0, 17, 3]
        assert [(e.path, e.offset, e.length) for e in
                port.batch_extents(idx, ["jpg", "cls"]).extents] == \
            [(e.path, e.offset, e.length) for e in
             ref.batch_extents(idx, ["jpg", "cls"]).extents]


@pytest.mark.parametrize("progressive", [False, True])
def test_parse_jpeg_info_agrees(progressive):
    img = np.random.default_rng(2).integers(0, 256, (37, 53, 3), np.uint8)
    data = _encode(img, progressive)
    port, ref = tjpeg.parse_jpeg_info(data), jjpeg.parse_jpeg_info(data)
    assert tuple(port) == tuple(ref) == (37, 53, progressive)
    arr = np.frombuffer(data, np.uint8)
    assert tjpeg.parse_jpeg_dims(arr) == jjpeg.parse_jpeg_dims(arr) == (37, 53)
    assert tjpeg.parse_jpeg_info(b"\x89PNG\r\n\x1a\n....") is None
    assert tjpeg.parse_jpeg_info(data[:20]) == jjpeg.parse_jpeg_info(data[:20])


def test_native_decode_agrees():
    """The port's libjpeg-turbo binding decodes as the JAX package's does:
    full, reduced and ROI."""
    if not (tjpeg.native_available() and jjpeg.native_available()):
        pytest.skip("no libjpeg-turbo on this host")
    img = np.random.default_rng(3).integers(0, 256, (91, 130, 3), np.uint8)
    data = _encode(img)
    tn, jn = tjpeg._resolve_native(), jjpeg._resolve_native()
    for reduced in (1, 2, 4, 8):
        np.testing.assert_array_equal(tn(data, reduced=reduced),
                                      jn(data, reduced=reduced))
    np.testing.assert_array_equal(tn(data, roi=(10, 21, 40, 50)),
                                  jn(data, roi=(10, 21, 40, 50)))
    with pytest.raises(ValueError):
        tn(data[:40])


def test_build_without_libjpeg_turbo(tmp_path, monkeypatch):
    """Where the probe cannot compile jpeglib.h with the turbo API (here an
    include path poisoned through STROM_JPEG_CFLAGS), the native library
    builds without the decoder, under another name than the decoder build
    (so a host that gains or loses the headers rebuilds), with a "0"
    marker, and reports sc_jpeg_available() == 0."""
    import ctypes

    from strom_torch._core import build

    bdir = str(tmp_path / "build")
    native = build.jpeg_probe()
    with_decoder = build.lib_path(bdir)
    poison = tmp_path / "inc"
    poison.mkdir()
    (poison / "jpeglib.h").write_text('#error "not libjpeg-turbo"\n')
    monkeypatch.setenv("STROM_JPEG_CFLAGS", f"-I{poison}")
    assert build.jpeg_probe() is False
    so = build.ensure_built(bdir)
    assert build.built_with_jpeg(so) is False
    assert ctypes.CDLL(so).sc_jpeg_available() == 0
    if native:
        assert so != with_decoder


def test_predecode_wds_writes_the_reference_files(wds_tar, tmp_path):
    port_out, ref_out = str(tmp_path / "port.pdec"), str(tmp_path / "ref.pdec")
    tctx, jctx = StromContext(StromConfig()), JContext(JConfig())
    try:
        assert predecode_wds(tctx, [wds_tar], port_out, image_size=SIZE,
                             decode_workers=2) == port_out
        j_predecode_wds(jctx, [wds_tar], ref_out, image_size=SIZE,
                        decode_workers=2)
    finally:
        tctx.close()
        jctx.close()
    for sfx in ("", LABELS_SUFFIX, META_SUFFIX):
        with open(port_out + sfx, "rb") as a, open(ref_out + sfx, "rb") as b:
            assert a.read() == b.read(), sfx
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    shards = PredecodedShardSet((port_out,), SIZE)
    assert shards.num_records == N_SAMPLES
    np.testing.assert_array_equal(shards.labels([0, 11, 23]), [0, 1, 3])


def test_predecoded_shard_set_refuses_stale_sidecars(wds_tar, tmp_path):
    out = str(tmp_path / "p.pdec")
    ctx = StromContext(StromConfig())
    try:
        predecode_wds(ctx, [wds_tar], out, image_size=SIZE, decode_workers=2)
    finally:
        ctx.close()
    with pytest.raises(ValueError, match="image_size"):
        PredecodedShardSet((out,), SIZE * 2)
    np.save(out + LABELS_SUFFIX, np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="stale"):
        PredecodedShardSet((out,), SIZE)
    os.unlink(out + LABELS_SUFFIX)
    with pytest.raises(FileNotFoundError, match="labels sidecar"):
        PredecodedShardSet((out,), SIZE)


@pytest.mark.parametrize("engine", ["python", "uring"])
def test_predecoded_pipeline_matches_reference(wds_tar, tmp_path, sharding1,
                                               engine):
    """Batches and labels across an epoch boundary (3 batches an epoch)."""
    pdec = str(tmp_path / "p.pdec")
    tctx = StromContext(StromConfig(queue_depth=8, **_engine_kw(engine)))
    jctx = JContext(JConfig(queue_depth=8, **_engine_kw(engine)))
    try:
        predecode_wds(tctx, [wds_tar], pdec, image_size=SIZE, decode_workers=2)
        records = np.fromfile(pdec, np.uint8).reshape(-1, SIZE, SIZE, 3)
        with make_predecoded_vision_pipeline(
                tctx, [pdec], batch=BATCH, image_size=SIZE, device="cpu",
                seed=3) as tp, j_make_predecoded(
                jctx, [pdec], batch=BATCH, image_size=SIZE,
                sharding=sharding1, seed=3) as jp:
            for _ in range(4):
                (ti, tl), (ji, jl) = next(tp), next(jp)
                np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
                np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
                assert str(ti.dtype) == "torch.uint8"
                assert str(tl.dtype) == "torch.int32"
                # the pixels are the shard's records, in the sampler's order
                assert any((records == ti.numpy()[0]).all(axis=(1, 2, 3)))
    finally:
        tctx.close()
        jctx.close()


@pytest.mark.parametrize("engine", ["python", "multi"])
def test_striped_predecoded_pipeline_matches_plain(wds_tar, tmp_path, engine):
    """stage_striped_predecoded stripes a shard over 3 members and aliases
    it, sidecars included: the alias's batches equal the plain shard's."""
    pdec = str(tmp_path / "p.pdec")
    members = [str(tmp_path / f"m{i}.bin") for i in range(3)]
    ctx = StromContext(StromConfig(queue_depth=8, **_engine_kw(engine)))
    try:
        predecode_wds(ctx, [wds_tar], pdec, image_size=SIZE, decode_workers=2)
        alias = stage_striped_predecoded(ctx, pdec, members, 8192)
        assert alias == pdec + ".raid0" and not os.path.exists(alias)
        got = {}
        for path in (pdec, alias):
            with make_predecoded_vision_pipeline(
                    ctx, [path], batch=BATCH, image_size=SIZE, device="cpu",
                    seed=5) as pipe:
                got[path] = [tuple(t.numpy() for t in next(pipe))
                             for _ in range(3)]
        for (a, la), (b, lb) in zip(got[pdec], got[alias]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
    finally:
        ctx.close()


def test_decode_config_matches_reference(monkeypatch):
    """The decode, streaming and watchdog fields: the reference's defaults,
    and the same STROM_* overrides."""
    fields = ("decode_reduced_scale", "decode_to_slot", "decode_overlap_put",
              "decode_native", "decode_fuse_runs", "decode_roi",
              "stream_intra_batch", "engine_wait_timeout_s")
    for f in fields:
        assert getattr(StromConfig(), f) == getattr(JConfig(), f), f
    monkeypatch.setenv("STROM_STREAM_INTRA_BATCH", "0")
    monkeypatch.setenv("STROM_DECODE_ROI", "false")
    monkeypatch.setenv("STROM_ENGINE_WAIT_TIMEOUT_S", "2.5")
    port, ref = StromConfig.from_env(), JConfig.from_env()
    for f in fields:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.stream_intra_batch is False and port.decode_roi is False
    assert port.engine_wait_timeout_s == 2.5
    with pytest.raises(ValueError, match="engine_wait_timeout_s"):
        StromConfig(engine_wait_timeout_s=0)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("engine", ["python", "uring"])
def test_wds_pipeline_matches_reference(wds_tar, sharding1, engine, native):
    """Bit-identical batches and labels, 4 batches over an epoch boundary,
    with each side's default (streamed) path. ``native=True`` compares the
    libjpeg-turbo routes (ROI and reduced decode included), False cv2's."""
    if native and not tjpeg.native_available():
        pytest.skip("no libjpeg-turbo on this host")
    port, stats = _port_batches(wds_tar, 4, engine=engine,
                                decode_native=native)
    ref = _ref_batches(wds_tar, sharding1, 4, engine=engine,
                       decode_native=native)
    for (ti, tl), (ji, jl) in zip(port, ref):
        assert ti.shape == (BATCH, SIZE, SIZE, 3) and ti.dtype == np.uint8
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        assert tl.dtype == np.int32
    routes = {k for k in stats if k.endswith("_imgs")}
    assert routes == ({"native_imgs"} if native else {"cv2_imgs"})
    # the prefetcher builds batches ahead of the 4 taken
    assert stats["decode_errors"] == 0 and stats["stream_batches"] >= 4


@pytest.mark.parametrize("engine", ["python", "uring", "multi"])
def test_streamed_and_barrier_paths_agree(wds_tar, engine):
    """The completion-driven path against the barrier one: same bytes; the
    streamed run really streamed, and dispatched samples while later
    extents were in flight (4 KiB pieces at queue depth 2 make the gather
    many rounds long)."""
    kw = dict(engine=engine, cfg=dict(block_size=4096, queue_depth=2))
    streamed, st = _port_batches(wds_tar, 4, **kw)
    barrier, sb = _port_batches(wds_tar, 4, stream_intra_batch=False, **kw)
    for (a, la), (b, lb) in zip(streamed, barrier):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    assert st["stream_batches"] >= 4 and st["stream_samples_early"] > 0
    assert "stream_batches" not in sb


def test_unfused_and_stack_paths_agree(wds_tar):
    """One task per sample (still streamed), the slot without the
    overlapped put and the stack path (neither streamed) all give the
    default path's bytes."""
    want, _ = _port_batches(wds_tar, 2)
    variants = [(dict(decode_fuse_runs=False), True),
                (dict(decode_overlap_put=False), False),
                (dict(decode_to_slot=False), False)]
    for kw, streamed in variants:
        got, stats = _port_batches(wds_tar, 2, **kw)
        for (a, la), (b, lb) in zip(got, want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
        assert ("stream_batches" in stats) == streamed, kw


def test_imagenet_resnet_pipeline_is_the_wds_pipeline(wds_tar):
    ctx = StromContext(StromConfig())
    try:
        with make_imagenet_resnet_pipeline(ctx, [wds_tar], batch=BATCH,
                                           image_size=SIZE, device="cpu",
                                           seed=11, decode_workers=2) as pipe:
            imgs, lbls = next(pipe)
    finally:
        ctx.close()
    want, _ = _port_batches(wds_tar, 1)
    np.testing.assert_array_equal(imgs.numpy(), want[0][0])
    np.testing.assert_array_equal(lbls.numpy(), want[0][1])


@pytest.mark.parametrize("stream", [True, False])
def test_failing_engine_fails_the_batch(wds_tar, stream):
    """Every read fails (fault_every=1): the batch raises EngineError, on
    both paths, and the pipeline closes cleanly."""
    ctx = StromContext(StromConfig(engine="python", fault_every=1))
    try:
        with make_wds_vision_pipeline(ctx, [wds_tar], batch=BATCH,
                                      image_size=SIZE, device="cpu",
                                      decode_workers=2,
                                      stream_intra_batch=stream) as pipe:
            with pytest.raises(EngineError):
                next(pipe)
    finally:
        ctx.close()


def test_zero_byte_sample_does_not_hang(tmp_path):
    """A sample whose members are both 0 bytes has no extent to wait for:
    the streamed path dispatches it up front, its empty image fails decode
    and raises as the barrier path does, neither hangs."""
    rng = np.random.default_rng(9)
    samples = []
    for i in range(BATCH):
        if i == 3:
            samples.append((f"s{i:04d}", {"jpg": b"", "cls": b""}))
            continue
        img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
        samples.append((f"s{i:04d}", {"jpg": _encode(img),
                                      "cls": str(i).encode()}))
    path = str(tmp_path / "degen.tar")
    make_wds_shard(path, samples)
    for stream in (True, False):
        with pytest.raises(Exception, match="(?i)empty|imdecode|decode"):
            _port_batches(path, 1, stream_intra_batch=stream,
                          decode_native=False)


def test_entry_points_raise_without_cuda(wds_tar, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = StromContext(StromConfig())
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_wds_vision_pipeline(ctx, [wds_tar], batch=BATCH,
                                     image_size=SIZE)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_predecoded_vision_pipeline(ctx, [wds_tar], batch=BATCH,
                                            image_size=SIZE)
    finally:
        ctx.close()
