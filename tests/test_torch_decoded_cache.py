"""The port's decoded-frame cache against the reference's: a JPEG
WebDataset pipeline over three epochs with ``decode_cache`` on gives the
batches of the cache off and of the reference's ``make_wds_vision_pipeline``
with the same settings, bit for bit, streamed and not; frames come from the
cache at plan time once they are admitted (the first epoch under
``always``, the second under ``second_touch``), and the counters say so.
Cached frames are full-resolution decodes, so every side decodes in full
(``decode_reduced_scale=False``), as the reference's own test does. Prefetch
depth 1 makes the order of admission and probe the same in every run."""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from strom.config import StromConfig as JConfig
from strom.delivery.core import StromContext as JContext
from strom.parallel.mesh import make_mesh
from strom.pipelines.vision import make_wds_vision_pipeline as j_make_wds
from strom_torch.config import StromConfig
from strom_torch.delivery.core import StromContext
from strom_torch.delivery.hotcache import HotCache
from strom_torch.formats.decoded_cache import DecodedCache, ServedFrame
from strom_torch.pipelines import make_wds_vision_pipeline
from tests.test_formats import make_wds_shard

cv2 = pytest.importorskip("cv2")

N_SAMPLES, BATCH, SIZE, EPOCHS = 16, 8, 32, 3
MiB = 1 << 20


@pytest.fixture(scope="module")
def wds_tar(tmp_path_factory):
    """16 seeded noise JPEGs of varying sizes (one progressive) with ASCII
    class labels."""
    rng = np.random.default_rng(9)
    samples = []
    for i in range(N_SAMPLES):
        img = rng.integers(0, 256, (64 + 4 * i, 80 + 2 * (i % 3), 3),
                           dtype=np.uint8)
        flags = [cv2.IMWRITE_JPEG_QUALITY, 90]
        if i == 7:
            flags += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        ok, buf = cv2.imencode(".jpg", img, flags)
        assert ok
        samples.append((f"s{i:04d}", {"jpg": buf.tobytes(),
                                      "cls": str(i % 10).encode()}))
    path = str(tmp_path_factory.mktemp("dcache") / "shard.tar")
    make_wds_shard(path, samples)
    return path


def _cfg(cls, cache: bool, admit: str):
    kw = dict(engine="python", queue_depth=8, num_buffers=8)
    if cache:
        kw.update(hot_cache_bytes=64 * MiB, hot_cache_admit=admit)
    return cls(**kw)


N_BATCHES = EPOCHS * N_SAMPLES // BATCH


def _port(path, *, cache: bool, admit: str = "always", stream: bool = True):
    ctx = StromContext(_cfg(StromConfig, cache, admit))
    try:
        with make_wds_vision_pipeline(
                ctx, [path], batch=BATCH, image_size=SIZE, device="cpu",
                seed=5, decode_workers=2, prefetch_depth=1,
                decode_reduced_scale=False, decode_cache=cache,
                stream_intra_batch=stream) as pipe:
            out = [tuple(t.numpy().copy() for t in next(pipe))
                   for _ in range(N_BATCHES)]
            return out, pipe.stats(), ctx.stats()
    finally:
        ctx.close()


def _reference(path, *, admit: str):
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    ctx = JContext(_cfg(JConfig, True, admit))
    try:
        with j_make_wds(ctx, [path], batch=BATCH, image_size=SIZE,
                        sharding=NamedSharding(mesh, P("dp", None, None,
                                                       None)),
                        seed=5, decode_workers=2, prefetch_depth=1,
                        decode_reduced_scale=False,
                        decode_cache=True) as pipe:
            return [tuple(np.asarray(t) for t in next(pipe))
                    for _ in range(N_BATCHES)]
    finally:
        ctx.close()


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("admit", ["always", "second_touch"])
def test_batches_identical_with_and_without_cache(wds_tar, admit, stream):
    got, pstats, cstats = _port(wds_tar, cache=True, admit=admit,
                                stream=stream)
    plain, _, _ = _port(wds_tar, cache=False, stream=stream)
    want = _reference(wds_tar, admit=admit)
    for (gi, gl), (pi, pl), (wi, wl) in zip(got, plain, want):
        assert np.array_equal(gi, pi) and np.array_equal(gl, pl)
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    # frames are admitted in epoch 1 (always) or 2 (second touch); every
    # later epoch finds all of them at plan time (the prefetcher may have
    # built one batch more by the time the counters are read)
    served = (EPOCHS - (1 if admit == "always" else 2)) * N_SAMPLES
    assert served <= pstats["decode_cache_plan_hits"] <= served + BATCH
    # a probe precedes its frame's crop
    assert served <= pstats["frames_from_cache"] \
        <= pstats["decode_cache_plan_hits"]
    assert pstats["decode_cache_plan_skipped_bytes"] > 0
    assert pstats["decode_cache_admitted_bytes"] > 0
    assert set(cstats["decode_cache"]) == {
        k for k in pstats if k.startswith("decode_cache_")}


def test_cache_off_without_hot_cache(wds_tar):
    """decode_cache needs the context's hot cache: without one the knob
    is inert and no decoded-cache counter appears."""
    ctx = StromContext(_cfg(StromConfig, False, "always"))
    try:
        with make_wds_vision_pipeline(ctx, [wds_tar], batch=BATCH,
                                      image_size=SIZE, device="cpu",
                                      decode_cache=True) as pipe:
            next(pipe)
            assert "decode_cache_hits" not in pipe.stats()
        assert ctx.decoded_cache is None and "decode_cache" not in ctx.stats()
    finally:
        ctx.close()


def test_served_frame_releases_once():
    hc = HotCache(4 * MiB, admit="always")
    dc = DecodedCache(hc)
    key = dc.key("shard.tar", 512, 4096)
    img = np.arange(6 * 5 * 3, dtype=np.uint8).reshape(6, 5, 3)
    assert dc.probe(key) is None            # no dims known yet
    assert dc.offer(key, img) == img.size
    frame = dc.probe(key, 3584)
    assert isinstance(frame, ServedFrame)
    assert np.array_equal(frame.img, img)
    entry = hc._lru[next(iter(hc._lru))]
    assert entry.refs == 1
    frame.release()
    frame.release()
    assert entry.refs == 0
    st = dc.stats()
    assert st["decode_cache_plan_hits"] == 1
    assert st["decode_cache_plan_skipped_bytes"] == 3584
    hc.enabled = False
    assert dc.probe(key) is None and not dc.enabled
