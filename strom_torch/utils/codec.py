"""Byte compression for the spill tier (the port's copy of
``strom/utils/codec.py``): probe for a fast codec, fall back to raw.

The probe takes ``lz4.frame`` where the interpreter has it, else the
standard library's ``zlib`` at level 1: a cheap, fast byte codec, not the
best ratio. :func:`default_codec` returning ``None`` means raw only.

:func:`maybe_compress` returns the raw bytes (codec ``None``) whenever the
compressed form is not smaller, so already-compressed payloads (JPEG
members, snappy chunks) are stored as they are. The spill tier records the
codec by name per entry, and :func:`get_codec` resolves the name.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

# the compression counters' names: the spill tier feeds the spill_* ones
# (the peer tier's are not ported); *_in = raw bytes entering the codec,
# *_out = stored bytes leaving it; ratio = in/out
COMP_FIELDS = (
    "spill_comp_bytes_in",
    "spill_comp_bytes_out",
    "spill_comp_ratio",
    "spill_decomp_bytes",
    "peer_comp_bytes_in",
    "peer_comp_bytes_out",
    "peer_comp_ratio",
    "peer_comp_fallbacks",
)


class Codec(NamedTuple):
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


def _probe() -> "Codec | None":
    try:
        import lz4.frame as _lz4  # type: ignore[import-not-found]

        return Codec("lz4", _lz4.compress, _lz4.decompress)
    except ImportError:
        pass
    try:
        import zlib

        return Codec("zlib", lambda b: zlib.compress(b, 1), zlib.decompress)
    except ImportError:  # pragma: no cover - zlib is stdlib
        return None


_DEFAULT = _probe()


def default_codec() -> "Codec | None":
    """The probed codec for this process (``None`` = raw only)."""
    return _DEFAULT


def get_codec(name: str) -> "Codec | None":
    """The codec called *name*, or None when this process lacks it."""
    if _DEFAULT is not None and name == _DEFAULT.name:
        return _DEFAULT
    if name == "zlib":
        import zlib

        return Codec("zlib", lambda b: zlib.compress(b, 1), zlib.decompress)
    return None


def maybe_compress(data, codec: "Codec | None"
                   ) -> "tuple[bytes, str | None]":
    """``(payload, codec_name)``: *data* compressed when that makes it
    smaller, else the raw bytes with ``codec_name`` None."""
    raw = bytes(data)
    if codec is None or len(raw) == 0:
        return raw, None
    comp = codec.compress(raw)
    if len(comp) >= len(raw):
        return raw, None
    return comp, codec.name
