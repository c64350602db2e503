"""The port's spill codec against the JAX package's: the same codec name
from the probe, equal ``maybe_compress`` payloads on the same seeded
inputs, and the raw bytes back where compression does not pay."""

import numpy as np
import pytest

from strom.utils import codec as ref_codec
from strom_torch.utils import codec as port_codec


def _inputs(seed: int) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 1 << 15, 1 << 16, dtype=np.int32)
    return {
        "tokens": tokens.tobytes(),                      # compressible
        "zeros": bytes(1 << 16),
        "random": rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes(),
        "tiny": b"\x01",
        "empty": b"",
        "ramp": np.arange(1 << 14, dtype=np.uint16).tobytes(),
    }


def test_probe_names_the_same_codec():
    ref, port = ref_codec.default_codec(), port_codec.default_codec()
    assert (port is None) == (ref is None)
    if ref is not None:
        assert port.name == ref.name
    assert port_codec.COMP_FIELDS == ref_codec.COMP_FIELDS


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["tokens", "zeros", "random", "tiny",
                                  "empty", "ramp"])
def test_maybe_compress_equals_reference(seed, kind):
    data = _inputs(seed)[kind]
    got = port_codec.maybe_compress(data, port_codec.default_codec())
    want = ref_codec.maybe_compress(data, ref_codec.default_codec())
    assert got == want
    payload, name = got
    if name is None:
        assert payload == data          # did not pay: the raw bytes
    else:
        assert len(payload) < len(data)
        assert port_codec.get_codec(name).decompress(payload) == data


@pytest.mark.parametrize("kind", ["random", "tiny", "empty"])
def test_raw_where_compression_does_not_pay(kind):
    data = _inputs(0)[kind]
    assert port_codec.maybe_compress(data, port_codec.default_codec()) == \
        (data, None)
    assert port_codec.maybe_compress(data, None) == (data, None)


def test_get_codec_resolves_names_as_reference():
    for name in ("zlib", "lz4", "nope"):
        got = port_codec.get_codec(name)
        want = ref_codec.get_codec(name)
        assert (got is None) == (want is None)
        if got is not None:
            blob = b"abc" * 1000
            assert got.name == want.name
            assert got.compress(blob) == want.compress(blob)
