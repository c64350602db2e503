"""Peer extent service (the port's copy of ``strom/dist/peers.py``; the
wire is the reference's byte for byte, so a host of either package serves
a host of the other).

Every host of the distributed data plane keys its hot cache and spill
tier by ``(path, physical offset)``, the one identity that is stable
across hosts too (the dataset files are shared). This module turns that
into a cooperative cache tier:

- :class:`PeerServer`: a small threaded TCP server each host runs,
  exporting its hot extents. A request names ``(path, lo, hi)`` and the
  server answers with the bytes when the whole range is resident in its
  hot cache or spill tier (RAM first, spill reads for the rest), else a
  one-byte miss. Serving never touches the source engine. Concurrency is
  bounded (``dist_server_max_conns``) and the local read is billed to the
  background-class ``"peer"`` tenant through the scheduler, so peer
  traffic never starves local demand.
- :class:`PeerTier`: the client side, probed by the delivery consult
  (``StromContext._consult_cache``) after local RAM and spill and before
  the engine. A pool of persistent connections a peer
  (``dist_conn_pool_size``); a failed or timed-out fetch is never fatal
  (the range falls back to the local engine read), and a dead peer trips
  a per-peer :class:`~strom_torch.engine.resilience.CircuitBreaker`, so a
  down host costs one cooldown, not a timeout a request.

On that wire sit a batched multi-extent op (``OP_GET_BATCH``: a gather's
peer misses ride one pipelined round trip a chunk), an optional
shared-key HMAC handshake (``OP_AUTH``, ``dist_auth_key``) on every new
connection, and decoded-frame keys (kind-1 batch items carrying a decode
fingerprint), so one host's DecodedCache serves crop-ready RGB to the
cluster. Owners come from a static ``owner_fn`` or from the
consistent-hash :class:`~strom_torch.dist.directory.ExtentDirectory`
the launcher attaches: breaker trips publish deaths, and membership
epochs re-own a dead host's keys fleet-wide.

Framing is length-prefixed binary: every frame is ``u32 payload length``
and the payload, so a truncated frame (a mid-stream hangup, the
``chaos_net`` fault preset) is a short read, never parsed as data.
Requests: ``op u8 | path_len u16 | path | lo u64 | hi u64``. Responses:
``status u8 | bytes`` (0 = hit, 1 = miss).

Trace propagation: an ``OP_GET_TRACED`` request appends a trace context
(req id, a process-unique flow id, the client's send timestamp, the
parent span's name) and the server answers with two timestamps of its
own (recv, send) ahead of the payload. The server records
``peer.queue``/``peer.grant``/``peer.copy``/``peer.send`` spans under the
inbound req id, each a step of the client's flow, so a merged fleet trace
draws one chain from the asking host's ``peer.fetch`` span through the
serving host's spans. The four timestamps double as an NTP-style clock
offset estimate a peer. A server of an older wire drops the connection on
an op it does not know: the client notices once, downgrades that peer,
and goes on fetching on the older op.

Counters (``DIST_FIELDS``, the ``stats()["dist"]`` section, /metrics):
client ``peer_hit_bytes``/``peer_hits``/``peer_misses``/``peer_errors``/
``peer_skips``/``peer_fetch_traced`` and the ``peer_rtt`` histogram
(written through a per-peer-address scope, so one slow peer shows apart
from fleet-wide slowness), server ``peer_served_bytes``/``peer_serves``/
``peer_serves_traced``/``peer_serve_misses``, breaker
``peer_breaker_trips`` and the ``peer_breaker_open`` gauge.

Neither lock (``dist.peer``, ``dist.server``) is ever held across socket
I/O: the client lock checks a connection out and back in, the server
lock guards counters only.
"""

from __future__ import annotations

import contextlib
import hashlib
import hmac
import itertools
import os
import socket
import struct
import threading
import time
from typing import Callable, Mapping, Sequence

import numpy as np

from strom_torch.engine.resilience import CircuitBreaker
from strom_torch.obs import request as _request
from strom_torch.obs.events import ring as _ring
from strom_torch.utils.codec import COMP_FIELDS as _COMP_FIELDS
from strom_torch.utils.codec import default_codec, get_codec
from strom_torch.utils.locks import make_lock

# The dist section of ``StromContext.stats()`` (→ /stats, /metrics),
# single-sourced so the exposition and the bench columns derived from it
# cannot drift from the producer.
DIST_FIELDS = (
    "peer_hit_bytes",
    "peer_hits",
    "peer_misses",
    "peer_errors",
    "peer_skips",
    "peer_fetch_traced",
    "peer_rtt_p50_us",
    "peer_rtt_p99_us",
    "peer_served_bytes",
    "peer_serves",
    "peer_serves_traced",
    "peer_serve_misses",
    "peer_breaker_trips",
    "peer_breaker_open",
    # peer fabric v2: batched transport, connection pool, auth
    # and decoded-frame serving. Client half: batches/extent counts + the
    # per-extent RTT gauge (the headline the batching exists to lower),
    # conn pool open/reuse counters + ratio gauge, decoded-frame fetch
    # tallies (kept SEPARATE from peer_hit_bytes — frame bytes are not
    # extent bytes, and the hit==served symmetry tests pin the extent
    # pair), and the consistent-hash directory's membership epoch.
    "peer_batches",
    "peer_batch_extents",
    "peer_rtt_per_extent_us",
    "peer_conn_opens",
    "peer_conn_reuses",
    "peer_conn_reuse_ratio",
    "peer_frame_hits",
    "peer_frame_misses",
    "peer_frame_hit_bytes",
    "peer_ring_epoch",
    # server half of fabric v2: batch request serves, auth refusals and
    # the decoded-frame exports (again separate from peer_served_bytes)
    "peer_batch_serves",
    "peer_auth_rejects",
    "peer_frame_serves",
    "peer_frame_served_bytes",
    "peer_frame_serve_misses",
    # zero-copy exporter accounting: payload bytes
    # sent straight from pinned cache views (zc), via sendfile(2) from the
    # spill file (sendfile), or through the legacy assemble-then-send bounce
    # (copy) — the ratio is the mechanism's before/after proof
    "peer_zc_bytes",
    "peer_sendfile_bytes",
    "peer_copy_bytes",
    # + the peer half of the compression counters, single-
    # sourced in utils/codec.py COMP_FIELDS: raw vs wire bytes of
    # compressed serves, the in/out ratio gauge, and raw-served fallbacks
    # (codec didn't pay / name unknown)
) + tuple(k for k in _COMP_FIELDS if k.startswith("peer_"))

# bench-JSON columns the dist arm emits (cli.py bench_dist). dist_ok folds the whole acceptance into one bit:
# every worker exited 0 AND every per-host batch stream was bit-identical
# to the single-process pipeline's corresponding rows.
DIST_BENCH_FIELDS = (
    "dist_ok",
    "dist_procs",
    "dist_steps",
    "dist_items_per_s",
    "dist_single_items_per_s",
    "dist_vs_single",
    "dist_peer_hit_ratio",
    "dist_peer_hit_bytes",
    "dist_peer_served_bytes",
    "dist_engine_ingest_bytes",
    "dist_assembly_wait_p99_us",
    "dist_peer_rtt_p99_us",
    # peer fabric v2 A/B: the batched arm vs an unbatched rerun
    # (dist_batch_max_extents=0: the one-extent-per-RTT transport),
    # plus the fabric gauges
    "dist_batch_vs_single",
    "dist_unbatched_items_per_s",
    "peer_rtt_per_extent_us",
    "peer_frame_hit_bytes",
    "peer_conn_reuse_ratio",
)

# wire protocol ------------------------------------------------------------
OP_GET = 1
OP_GET_TRACED = 2
# compressed-capable requests: byte-identical to the
# corresponding plain op plus a trailing ``codec_len u16 | codec name``
# advertising the codec the CLIENT can decompress. A willing server may
# answer ST_HIT_COMP (``raw_len u64 | compressed bytes`` after the status/
# trace header) when compression pays, or a plain raw ST_HIT otherwise —
# an old server sees an unknown op and drops the conn, and the client's
# per-peer ``comp_ok`` latch downgrades exactly like ``trace_ok``.
OP_GET_COMP = 3
OP_GET_TRACED_COMP = 4
# fabric v2 ops: OP_GET_BATCH carries a whole gather's worth of
# keys in one frame (``op u8 | count u16 | flags u8 | [trace ctx] |
# [codec] | count × key``, each key ``kind u8 | path_len u16 | path |
# lo u64 | hi u64 | [fp_len u16 | fingerprint]``) and the server streams
# back count individual response frames in key order — one round trip per
# batch instead of per extent. Key kinds: 0 = source extent (payload =
# bytes, ST_HIT_COMP legal like the plain wire), 1 = decoded frame
# (payload = ``h u32 | w u32 | rgb bytes`` out of the owner's
# DecodedCache). OP_AUTH opens the optional shared-key handshake: client
# sends the bare op, server answers a 16-byte nonce frame, client answers
# HMAC-SHA256(key, nonce), server answers ST_AUTH_OK / ST_AUTH_REJECT.
# Both ops are unknown to a v1 server, which drops the conn — the
# client's per-peer ``batch_ok`` latch downgrades to single-extent ops
# exactly like ``comp_ok``/``trace_ok`` (newest wire downgrades first).
OP_GET_BATCH = 5
OP_AUTH = 6
ST_HIT, ST_MISS = 0, 1
ST_HIT_COMP = 2
ST_AUTH_OK, ST_AUTH_REJECT = 3, 4
_LEN = struct.Struct("!I")
_CODEC_LEN = struct.Struct("!H")
_RAW_LEN = struct.Struct("!Q")
_REQ_HEAD = struct.Struct("!BH")
_REQ_RANGE = struct.Struct("!QQ")
# trace context appended to an OP_GET_TRACED request: req_id u64 | flow_id
# u64 | client send ts f64 (its ring timebase) | parent_len u16 | parent
# bytes. A traced response echoes (server recv ts, server send ts) — the
# server ring's timebase — right after the status byte, for both hits and
# misses, so every traced exchange carries the four NTP timestamps.
_TRACE_CTX = struct.Struct("!QQdH")
_TRACED_RESP = struct.Struct("!dd")
# batch framing: header + per-key layout, see OP_GET_BATCH
_BATCH_HEAD = struct.Struct("!BHB")
_KEY_HEAD = struct.Struct("!BH")
_FP_LEN = struct.Struct("!H")
_DIMS = struct.Struct("!II")
KIND_EXTENT, KIND_FRAME = 0, 1
_BF_TRACED, _BF_COMP = 0x1, 0x2
AUTH_NONCE_LEN = 16
# sanity bound on any single frame: an extent-sized response, never a
# whole-file stream (the consult asks per miss run, which is bounded by
# the gather's chunking) — a corrupt length prefix fails fast instead of
# allocating gigabytes
MAX_FRAME = 64 * 1024 * 1024


class PeerProtocolError(RuntimeError):
    """Malformed or truncated peer frame (hangup mid-stream included)."""


# MSG_ZEROCOPY plumbing: the flag values are ABI constants from
# <linux/socket.h> / <asm-generic/socket.h>, absent from the socket module
# on older Pythons — spell them out, probe SO_ZEROCOPY at runtime
_SO_ZEROCOPY = getattr(socket, "SO_ZEROCOPY", 60)
_MSG_ZEROCOPY = getattr(socket, "MSG_ZEROCOPY", 0x4000000)
_MSG_ERRQUEUE = getattr(socket, "MSG_ERRQUEUE", 0x2000)
# below this, MSG_ZEROCOPY's page-pinning setup costs more than the copy
# it saves (kernel docs put the break-even around 10 KiB)
_ZC_MIN_SEND = 32 * 1024


class _ZcState:
    """Per-connection MSG_ZEROCOPY bookkeeping: the kernel numbers each
    zc send 0,1,2,… per socket and acknowledges inclusive sequence ranges
    on the error queue once it has dropped its page references."""

    __slots__ = ("seq", "acked")

    def __init__(self):
        self.seq = 0    # zc sends issued (next send gets seq)
        self.acked = 0  # completions reaped: all of [0, acked) are done


def send_frame(sock: socket.socket, payload) -> None:
    """One length-prefixed frame. *payload* is bytes-like (a list/tuple
    concatenates without an intermediate copy of the data part)."""
    if isinstance(payload, (list, tuple)):
        head = _LEN.pack(sum(len(p) for p in payload))
        sock.sendall(head)
        for p in payload:
            sock.sendall(p)
        return
    sock.sendall(_LEN.pack(len(payload)))
    sock.sendall(payload)


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly *n* bytes or :class:`PeerProtocolError` (EOF mid-frame is
    how a killed peer looks from here)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise PeerProtocolError(
                f"peer hung up mid-frame ({got}/{n} bytes)")
        got += r
    return buf


def recv_frame(sock: socket.socket, max_len: int = MAX_FRAME) -> bytearray:
    (n,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if n > max_len:
        raise PeerProtocolError(f"frame of {n} bytes exceeds cap {max_len}")
    return recv_exact(sock, n)


def encode_request(path: str, lo: int, hi: int,
                   trace: "tuple[int, int, float, str] | None" = None,
                   codec: "str | None" = None) -> bytes:
    """One request frame. *trace* = (req_id, flow_id, send_us, parent)
    upgrades the op to OP_GET_TRACED; *codec* upgrades it to the _COMP
    variant carrying the advertised codec name. Both None is
    the plain ``OP_GET`` wire."""
    p = path.encode("utf-8")
    if len(p) > 0xFFFF:
        raise ValueError(f"path too long for the wire ({len(p)} bytes)")
    suffix = b""
    if codec is not None:
        cb = codec.encode("utf-8")[:0xFFFF]
        suffix = _CODEC_LEN.pack(len(cb)) + cb
    if trace is None:
        op = OP_GET if codec is None else OP_GET_COMP
        return (_REQ_HEAD.pack(op, len(p)) + p + _REQ_RANGE.pack(lo, hi)
                + suffix)
    req_id, flow_id, send_us, parent = trace
    pb = parent.encode("utf-8")[:0xFFFF]
    op = OP_GET_TRACED if codec is None else OP_GET_TRACED_COMP
    return (_REQ_HEAD.pack(op, len(p)) + p
            + _REQ_RANGE.pack(lo, hi)
            + _TRACE_CTX.pack(int(req_id), int(flow_id), float(send_us),
                              len(pb)) + pb + suffix)


def decode_request(payload) -> tuple[str, int, int]:
    if len(payload) < _REQ_HEAD.size + _REQ_RANGE.size:
        raise PeerProtocolError(f"request frame too short ({len(payload)})")
    op, plen = _REQ_HEAD.unpack_from(payload, 0)
    if op != OP_GET:
        raise PeerProtocolError(f"unknown peer op {op}")
    end = _REQ_HEAD.size + plen
    if len(payload) != end + _REQ_RANGE.size:
        raise PeerProtocolError("request frame length mismatch")
    path = bytes(payload[_REQ_HEAD.size: end]).decode("utf-8")
    lo, hi = _REQ_RANGE.unpack_from(payload, end)
    if hi < lo:
        raise PeerProtocolError(f"bad range [{lo}, {hi})")
    return path, lo, hi


def decode_request_ex(payload
                      ) -> "tuple[str, int, int, dict | None, str | None]":
    """:func:`decode_request` that also understands the traced and
    compressed-capable ops — the server's decoder. Returns
    ``(path, lo, hi, trace, codec)`` with *trace* None for an untraced op
    or ``{"req", "flow", "send_us", "parent"}``, and *codec* the
    advertised codec name of a _COMP op (None otherwise); the same
    exact-length strictness per op (trailing bytes are a protocol error,
    never silently ignored)."""
    total = len(payload)
    if total < _REQ_HEAD.size + _REQ_RANGE.size:
        raise PeerProtocolError(f"request frame too short ({total})")
    op, plen = _REQ_HEAD.unpack_from(payload, 0)
    if op not in (OP_GET, OP_GET_TRACED, OP_GET_COMP, OP_GET_TRACED_COMP):
        raise PeerProtocolError(f"unknown peer op {op}")
    end = _REQ_HEAD.size + plen
    pos = end + _REQ_RANGE.size
    trace = None
    if op in (OP_GET_TRACED, OP_GET_TRACED_COMP):
        if total < pos + _TRACE_CTX.size:
            raise PeerProtocolError("traced request frame too short")
        req_id, flow_id, send_us, par_len = _TRACE_CTX.unpack_from(
            payload, pos)
        pos += _TRACE_CTX.size
        if total < pos + par_len:
            raise PeerProtocolError("request frame length mismatch")
        parent = bytes(payload[pos: pos + par_len]).decode("utf-8")
        pos += par_len
        trace = {"req": req_id, "flow": flow_id, "send_us": send_us,
                 "parent": parent}
    codec = None
    if op in (OP_GET_COMP, OP_GET_TRACED_COMP):
        if total < pos + _CODEC_LEN.size:
            raise PeerProtocolError("comp request frame too short")
        (clen,) = _CODEC_LEN.unpack_from(payload, pos)
        pos += _CODEC_LEN.size
        if total < pos + clen:
            raise PeerProtocolError("request frame length mismatch")
        codec = bytes(payload[pos: pos + clen]).decode("utf-8")
        pos += clen
    if total != pos:
        raise PeerProtocolError("request frame length mismatch")
    path = bytes(payload[_REQ_HEAD.size: end]).decode("utf-8")
    lo, hi = _REQ_RANGE.unpack_from(payload, end)
    if hi < lo:
        raise PeerProtocolError(f"bad range [{lo}, {hi})")
    return path, lo, hi, trace, codec


def encode_batch_request(keys: Sequence, *,
                         trace: "tuple[int, int, float, str] | None" = None,
                         codec: "str | None" = None) -> bytes:
    """One OP_GET_BATCH frame for *keys*: each key is ``(path, lo, hi)``
    (a source extent) or ``(path, lo, hi, fingerprint)`` (a decoded
    frame). *trace*/*codec* raise the corresponding header flags — one
    trace context and one codec ask cover the whole batch, the server
    echoes/honours them per item."""
    if not 0 < len(keys) <= 0xFFFF:
        raise ValueError(f"bad batch size {len(keys)}")
    flags = ((_BF_TRACED if trace is not None else 0)
             | (_BF_COMP if codec is not None else 0))
    parts = [_BATCH_HEAD.pack(OP_GET_BATCH, len(keys), flags)]
    if trace is not None:
        req_id, flow_id, send_us, parent = trace
        pb = parent.encode("utf-8")[:0xFFFF]
        parts.append(_TRACE_CTX.pack(int(req_id), int(flow_id),
                                     float(send_us), len(pb)) + pb)
    if codec is not None:
        cb = codec.encode("utf-8")[:0xFFFF]
        parts.append(_CODEC_LEN.pack(len(cb)) + cb)
    for key in keys:
        path, lo, hi = key[0], int(key[1]), int(key[2])
        fp = key[3] if len(key) > 3 else None
        p = path.encode("utf-8")
        if len(p) > 0xFFFF:
            raise ValueError(f"path too long for the wire ({len(p)} bytes)")
        kind = KIND_EXTENT if fp is None else KIND_FRAME
        parts.append(_KEY_HEAD.pack(kind, len(p)) + p
                     + _REQ_RANGE.pack(lo, hi))
        if fp is not None:
            fb = str(fp).encode("utf-8")[:0xFFFF]
            parts.append(_FP_LEN.pack(len(fb)) + fb)
    return b"".join(parts)


def decode_batch_request(payload) -> "tuple[list, dict | None, str | None]":
    """The server's OP_GET_BATCH decoder → ``(keys, trace, codec)`` with
    each key ``(kind, path, lo, hi, fp)`` (*fp* None for extents). Same
    exact-length strictness as the single-op decoders."""
    total = len(payload)
    if total < _BATCH_HEAD.size:
        raise PeerProtocolError(f"batch frame too short ({total})")
    op, count, flags = _BATCH_HEAD.unpack_from(payload, 0)
    if op != OP_GET_BATCH:
        raise PeerProtocolError(f"not a batch op ({op})")
    if count == 0:
        raise PeerProtocolError("empty batch")
    pos = _BATCH_HEAD.size
    trace = None
    if flags & _BF_TRACED:
        if total < pos + _TRACE_CTX.size:
            raise PeerProtocolError("batch frame too short for trace ctx")
        req_id, flow_id, send_us, par_len = _TRACE_CTX.unpack_from(
            payload, pos)
        pos += _TRACE_CTX.size
        if total < pos + par_len:
            raise PeerProtocolError("batch frame length mismatch")
        parent = bytes(payload[pos: pos + par_len]).decode("utf-8")
        pos += par_len
        trace = {"req": req_id, "flow": flow_id, "send_us": send_us,
                 "parent": parent}
    codec = None
    if flags & _BF_COMP:
        if total < pos + _CODEC_LEN.size:
            raise PeerProtocolError("batch frame too short for codec")
        (clen,) = _CODEC_LEN.unpack_from(payload, pos)
        pos += _CODEC_LEN.size
        if total < pos + clen:
            raise PeerProtocolError("batch frame length mismatch")
        codec = bytes(payload[pos: pos + clen]).decode("utf-8")
        pos += clen
    keys = []
    for _ in range(count):
        if total < pos + _KEY_HEAD.size:
            raise PeerProtocolError("batch key truncated")
        kind, plen = _KEY_HEAD.unpack_from(payload, pos)
        if kind not in (KIND_EXTENT, KIND_FRAME):
            raise PeerProtocolError(f"unknown batch key kind {kind}")
        pos += _KEY_HEAD.size
        if total < pos + plen + _REQ_RANGE.size:
            raise PeerProtocolError("batch key truncated")
        path = bytes(payload[pos: pos + plen]).decode("utf-8")
        pos += plen
        lo, hi = _REQ_RANGE.unpack_from(payload, pos)
        pos += _REQ_RANGE.size
        if hi < lo:
            raise PeerProtocolError(f"bad range [{lo}, {hi})")
        fp = None
        if kind == KIND_FRAME:
            if total < pos + _FP_LEN.size:
                raise PeerProtocolError("batch key truncated")
            (flen,) = _FP_LEN.unpack_from(payload, pos)
            pos += _FP_LEN.size
            if total < pos + flen:
                raise PeerProtocolError("batch key truncated")
            fp = bytes(payload[pos: pos + flen]).decode("utf-8")
            pos += flen
        keys.append((kind, path, lo, hi, fp))
    if total != pos:
        raise PeerProtocolError("batch frame length mismatch")
    return keys, trace, codec


# cross-host flow ids: a request's per-process int id collides across
# hosts, so the arrow chain binds on a separate id seeded from urandom —
# unique across the fleet w.h.p., monotonic within a process
_flow_ids = itertools.count(int.from_bytes(os.urandom(6), "big") << 16)


def split_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host, int(port)


class PeerServer:
    """Threaded TCP exporter of one context's hot extents.

    Serving reads ONLY the local RAM/spill tiers — a range not fully
    resident answers miss, never a source read (the whole point is that
    the OWNER already paid the SSD read once). The local copy out of the
    tiers runs under a background-class scheduler grant billed to the
    ``"peer"`` tenant (registered by ``StromContext.serve_peers``), so a
    storm of peer requests queues behind every local demand gather.
    """

    def __init__(self, ctx, host: str = "127.0.0.1", port: int = 0, *,
                 max_conns: int = 8):
        self._ctx = ctx
        self._scope = ctx.scope
        self._closed = False
        self._lock = make_lock("dist.server")
        self._sem = threading.Semaphore(max(int(max_conns), 1))
        self.served_bytes = 0
        self.serves = 0
        self.serves_traced = 0
        self.serve_misses = 0
        # zero-copy exporter: serve hits
        # straight from the pinned tier views / the spill file instead of
        # assembling a bounce buffer. Off = the copy path, byte for
        # byte.
        self._zc = bool(getattr(getattr(ctx, "config", None),
                                "dist_send_zc", False))
        self.zc_bytes = 0
        self.sendfile_bytes = 0
        self.copy_bytes = 0
        # response compression:
        # honoured only for codec-advertising requests on the copy path —
        # the zc path keeps serving raw (a comp request accepts ST_HIT).
        self._comp = bool(getattr(getattr(ctx, "config", None),
                                  "peer_compress", False))
        self.comp_bytes_in = 0
        self.comp_bytes_out = 0
        self.comp_fallbacks = 0
        # fabric v2: shared-key auth (dist_auth_key, off by
        # default = the v1 open wire), batch serves and decoded-frame
        # exports out of the context's DecodedCache
        self._auth_key = str(getattr(getattr(ctx, "config", None),
                                     "dist_auth_key", "") or "")
        self.batch_serves = 0
        self.auth_rejects = 0
        self.frame_serves = 0
        self.frame_served_bytes = 0
        self.frame_serve_misses = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._host, self._port = self._sock.getsockname()[:2]
        self._accept = threading.Thread(target=self._run_accept,
                                        name="strom-peer-accept",
                                        daemon=True)
        self._accept.start()
        # self-identity marker: the trace merger pairs each host's trace
        # file with the clock offsets OTHER hosts estimated for this addr
        _ring.instant("peer.self", cat="dist", args={"addr": self.addr})

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    # -- accept / serve -----------------------------------------------------
    def _run_accept(self) -> None:
        n = 0
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            n += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name=f"strom-peer-serve-{n}",
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            zstate: "_ZcState | None" = None
            if self._zc:
                # per-conn MSG_ZEROCOPY probe: SO_ZEROCOPY is refused on
                # kernels without it (or on loopback-disabled configs) —
                # the conn then serves pinned-view sends without the flag,
                # still no userspace bounce
                try:
                    conn.setsockopt(socket.SOL_SOCKET, _SO_ZEROCOPY, 1)
                    zstate = _ZcState()
                except OSError:
                    zstate = None
            # auth gate: with a key configured the FIRST frame
            # must be OP_AUTH and the handshake must verify — anything
            # else is refused with one clean ST_AUTH_REJECT frame (counted
            # peer_auth_rejects) and the conn dropped. A keyless server
            # still answers an authing client's handshake (nonce → OK
            # without verifying) so mixed configs degrade to open, not to
            # a wedged fleet.
            authed = not self._auth_key
            while not self._closed:
                try:
                    frame = recv_frame(conn)
                except (PeerProtocolError, OSError, ValueError):
                    return  # peer went away / spoke garbage: drop the conn
                op = frame[0] if frame else -1
                if op == OP_AUTH:
                    if not self._auth_conn(conn, frame):
                        return
                    authed = True
                    continue
                if not authed:
                    self._reject_auth(conn)
                    return
                if op == OP_GET_BATCH:
                    if not self._serve_batch(conn, frame):
                        return
                    continue
                try:
                    path, lo, hi, trace, req_codec = decode_request_ex(frame)
                except (PeerProtocolError, ValueError):
                    return  # unknown op / malformed frame: drop the conn
                recv_us = _ring.now_us() if trace is not None else 0.0
                # bounded concurrency PER REQUEST, not per connection:
                # every remote host keeps one pooled conn open for its
                # lifetime, so a connection-scoped slot would wedge the
                # service the moment peers outnumber max_conns — only
                # in-flight local reads hold a slot, any number of idle
                # conns park here costing a blocked thread each
                # the semaphore is a counting slot pool, not a mutex: N
                # independent slots can't nest or invert, and the billed
                # read under it enters the lock hierarchy at the scheduler
                # band exactly as it would uncontended — hence the
                # per-call-site lock-order suppressions below
                served: "tuple[int, int, int] | None" = None
                data = None
                q0 = _ring.now_us() if trace is not None else 0.0
                with self._sem:
                    if trace is not None:
                        self._span(trace, "peer.queue", q0,
                                   _ring.now_us() - q0)
                    if self._zc:
                        try:
                            served = self._serve_range_zc(conn, path, lo,
                                                          hi, zstate,
                                                          trace=trace,
                                                          recv_us=recv_us)
                        except OSError:
                            return  # conn already destroyed by the zc path
                    else:
                        data = self._serve_range(path, lo, hi, trace=trace)
                # tally BEFORE the reply frame leaves: the moment the
                # client sees the frame it may read our stats (tests and
                # strom_top sample right after a pread returns), and a
                # post-send tally loses that race
                if self._zc:
                    self._tally(None if served is None else served[0],
                                traced=trace is not None)
                    if served is None:
                        try:
                            send_frame(conn, self._miss_frame(trace,
                                                              recv_us))
                        except OSError:
                            return
                    continue
                self._tally(None if data is None else data.nbytes,
                            copied=True, traced=trace is not None)
                comp = None
                if data is not None and req_codec is not None and self._comp:
                    comp = self._try_compress(data, req_codec)
                s0 = _ring.now_us() if trace is not None else 0.0
                tr = (_TRACED_RESP.pack(recv_us, s0)
                      if trace is not None else b"")
                try:
                    if data is None:
                        send_frame(conn, self._miss_frame(trace, recv_us))
                    elif comp is not None:
                        send_frame(conn, (bytes([ST_HIT_COMP]), tr,
                                          _RAW_LEN.pack(data.nbytes), comp))
                    else:
                        send_frame(conn, (bytes([ST_HIT]), tr, data.data))
                except OSError:
                    return
                if trace is not None:
                    self._span(trace, "peer.send", s0, _ring.now_us() - s0)
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def _span(self, trace: dict, name: str, ts_us: float,
              dur_us: float) -> None:
        """One server-side span billed under the inbound req id, carrying a
        step of the client's flow chain. The flow event lands at now(),
        inside the [ts_us, ts_us+dur_us) slice being emitted — the same
        binds-to-the-enclosing-slice trick Request._flow uses."""
        _ring.flow("t", trace["flow"], "peer.req", "reqx")
        args = {"req": trace["req"]}
        if trace.get("parent"):
            args["parent"] = trace["parent"]
        _ring.complete(ts_us, dur_us, "dist", name, args)

    @staticmethod
    def _miss_frame(trace: "dict | None", recv_us: float) -> bytes:
        if trace is None:
            return bytes([ST_MISS])
        return bytes([ST_MISS]) + _TRACED_RESP.pack(recv_us, _ring.now_us())

    def _tally(self, n: "int | None", *, copied: bool = False,
               traced: bool = False) -> None:
        with self._lock:
            if n is None:
                self.serve_misses += 1
            else:
                self.serves += 1
                self.served_bytes += n
                if copied:
                    self.copy_bytes += n
                if traced:
                    self.serves_traced += 1
        if n is None:
            self._scope.add("peer_serve_misses")
        else:
            self._scope.add("peer_serves")
            self._scope.add("peer_served_bytes", n)
            if traced:
                self._scope.add("peer_serves_traced")

    def _try_compress(self, data, codec_name: str) -> "bytes | None":
        """Compress a hit for a codec-advertising peer, or None to serve
        raw: unknown codec and doesn't-pay payloads both fall back (each
        counted peer_comp_fallbacks — the wire stays correct either way,
        a comp request always accepts a plain ST_HIT)."""
        codec = get_codec(codec_name)
        comp = codec.compress(data.tobytes()) if codec is not None else None
        if comp is None or len(comp) >= data.nbytes:
            with self._lock:
                self.comp_fallbacks += 1
            self._scope.add("peer_comp_fallbacks")
            return None
        with self._lock:
            self.comp_bytes_in += data.nbytes
            self.comp_bytes_out += len(comp)
            ratio = round(self.comp_bytes_in / self.comp_bytes_out, 4)
        self._scope.add("peer_comp_bytes_in", data.nbytes)
        self._scope.add("peer_comp_bytes_out", len(comp))
        self._scope.set_gauge("peer_comp_ratio", ratio)
        return comp

    # -- fabric v2: auth handshake / batch serving ----------------
    def _auth_conn(self, conn: socket.socket, frame) -> bool:
        """One OP_AUTH challenge/response exchange. Returns True when the
        conn may proceed (HMAC verified, or no key configured here — a
        keyless server humours an authing client)."""
        if len(frame) != 1:
            return False
        nonce = os.urandom(AUTH_NONCE_LEN)
        try:
            send_frame(conn, nonce)
            mac = bytes(recv_frame(conn, max_len=1024))
        except (PeerProtocolError, OSError):
            return False
        if self._auth_key:
            want = hmac.new(self._auth_key.encode("utf-8"), nonce,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(mac, want):
                self._reject_auth(conn)
                return False
        with contextlib.suppress(OSError):
            send_frame(conn, bytes([ST_AUTH_OK]))
        return True

    def _reject_auth(self, conn: socket.socket) -> None:
        with self._lock:
            self.auth_rejects += 1
        self._scope.add("peer_auth_rejects")
        with contextlib.suppress(OSError):
            send_frame(conn, bytes([ST_AUTH_REJECT]))

    def _serve_batch(self, conn: socket.socket, frame) -> bool:
        """One OP_GET_BATCH frame: serve every key in order, streaming one
        response frame per key (the client drains them sequentially —
        that stream IS the single round trip). Each item takes its own
        bounded-concurrency slot and its own tally, so batched serving is
        accounting-identical to N single serves plus one peer_batch_serves
        tick. Returns False when the conn must close (send failure or a
        malformed frame)."""
        try:
            keys, trace, req_codec = decode_batch_request(frame)
        except (PeerProtocolError, ValueError):
            return False
        recv_us = _ring.now_us() if trace is not None else 0.0
        with self._lock:
            self.batch_serves += 1
        self._scope.add("peer_batch_serves")
        for kind, path, lo, hi, fp in keys:
            if kind == KIND_FRAME:
                with self._sem:
                    res = self._serve_frame(path, lo, hi, fp)
                s0 = _ring.now_us() if trace is not None else 0.0
                tr = (_TRACED_RESP.pack(recv_us, s0)
                      if trace is not None else b"")
                try:
                    if res is None:
                        send_frame(conn, bytes([ST_MISS]) + tr)
                    else:
                        h, w, rgb = res
                        send_frame(conn, (bytes([ST_HIT]), tr,
                                          _DIMS.pack(h, w), rgb))
                except OSError:
                    return False
                continue
            q0 = _ring.now_us() if trace is not None else 0.0
            with self._sem:
                if trace is not None:
                    self._span(trace, "peer.queue", q0, _ring.now_us() - q0)
                data = self._serve_range(path, lo, hi, trace=trace)
            # same tally-before-send contract as the single-op path
            self._tally(None if data is None else data.nbytes,
                        copied=data is not None, traced=trace is not None)
            comp = None
            if data is not None and req_codec is not None and self._comp:
                comp = self._try_compress(data, req_codec)
            s0 = _ring.now_us() if trace is not None else 0.0
            tr = (_TRACED_RESP.pack(recv_us, s0)
                  if trace is not None else b"")
            try:
                if data is None:
                    send_frame(conn, bytes([ST_MISS]) + tr)
                elif comp is not None:
                    send_frame(conn, (bytes([ST_HIT_COMP]), tr,
                                      _RAW_LEN.pack(data.nbytes), comp))
                else:
                    send_frame(conn, (bytes([ST_HIT]), tr, data.data))
            except OSError:
                return False
            if trace is not None:
                self._span(trace, "peer.send", s0, _ring.now_us() - s0)
        return True

    def _serve_frame(self, path: str, lo: int, hi: int, fp: "str | None"
                     ) -> "tuple[int, int, bytes] | None":
        """One decoded-frame export (kind-1 batch key) out of this
        context's DecodedCache: ``(h, w, rgb bytes)`` when the frame is
        resident under a matching decode fingerprint, else None — never a
        local decode (the whole point is the owner already paid it)."""
        dc = getattr(self._ctx, "decoded_cache", None)
        res = None
        if dc is not None and not self._closed:
            try:
                res = dc.export(path, lo, hi, fingerprint=fp)
            # any local failure answers miss (peer_frame_serve_misses) and
            # the asker decodes locally
            except Exception:
                res = None
        with self._lock:
            if res is None:
                self.frame_serve_misses += 1
            else:
                self.frame_serves += 1
                self.frame_served_bytes += len(res[2])
        if res is None:
            self._scope.add("peer_frame_serve_misses")
        else:
            self._scope.add("peer_frame_serves")
            self._scope.add("peer_frame_served_bytes", len(res[2]))
        return res

    def _serve_range(self, path: str, lo: int, hi: int, *,
                     trace: "dict | None" = None) -> "np.ndarray | None":
        """The billed local read: full-range coverage from RAM + spill, or
        None (a partial range is a miss — the asker's engine read is
        cheaper than a split conversation)."""
        n = hi - lo
        if n <= 0 or n + 1 > MAX_FRAME or self._closed:
            return None
        sched = getattr(self._ctx, "scheduler", None)
        try:
            if sched is not None:
                # billed serve: one background-class grant per
                # range — demand gathers of every local tenant outrank it
                # in the fair drain, and the per-tenant budget/accounting
                # machinery sees peer traffic like any other tenant's.
                # Held across the tier memcpy/pread only, NEVER across
                # socket I/O (the caller sends after we return).
                g0 = _ring.now_us() if trace is not None else 0.0
                with sched.grant("peer", n, priority="background"):
                    if trace is not None:
                        self._span(trace, "peer.grant", g0,
                                   _ring.now_us() - g0)
                    return self._read_traced(path, lo, hi, trace)
            return self._read_traced(path, lo, hi, trace)
        # local failure (closing context, deadline on the grant) answers
        # miss and is visible as peer_serve_misses; the asker falls back
        # to its own engine
        except Exception:
            return None

    # -- zero-copy serving --------------------------
    def _plan_local(self, path: str, lo: int, hi: int):
        """Pin-and-plan: the wire segments covering [lo, hi) in offset
        order, with tier pins HELD on return (the caller unpins after the
        send — pins are refcounts, not locks, so holding them across
        socket I/O is legal and is exactly what makes the no-bounce send
        safe against concurrent eviction). Returns
        ``(segs, cache, pinned, spill, sp_pinned)`` or None for any gap."""
        cache = getattr(self._ctx, "hot_cache", None)
        if cache is None or not cache.enabled:
            return None
        hits, misses, pinned = cache.lookup(path, lo, hi, record=False)
        spill = cache.spill
        sp_pinned: list = []
        segs: list = [(s, ("mem", view, 0, t - s)) for s, t, view in hits]
        ok = True
        if misses:
            if spill is None:
                ok = False
            else:
                for s, t in misses:
                    if not ok:
                        break
                    sp_hits, sp_misses = spill.lookup(path, s, t,
                                                      record=False)
                    sp_pinned.extend(e for _, _, e in sp_hits)
                    if sp_misses:
                        ok = False
                        break
                    for ss, tt, ent in sp_hits:
                        fr = spill.file_range(ent, ss, tt)
                        if fr is None:
                            # compressed spill entry: no sendfile identity
                            # between file bytes and logical bytes — fall
                            # back to a decompressed bounce segment (the
                            # entry stays pinned like any other)
                            tmp = np.empty(tt - ss, np.uint8)
                            spill.read_into(ent, ss, tt, tmp)
                            segs.append((ss, ("mem", tmp, 0, tt - ss)))
                        else:
                            fd, off, ln = fr
                            segs.append((ss, ("file", fd, off, ln)))
        if not ok:
            if spill is not None:
                spill.unpin(sp_pinned)
            cache.unpin(pinned)
            return None
        segs.sort(key=lambda kv: kv[0])
        return ([seg for _, seg in segs], cache, pinned, spill, sp_pinned)

    def _serve_range_zc(self, conn: socket.socket, path: str, lo: int,
                        hi: int, zstate: "_ZcState | None", *,
                        trace: "dict | None" = None, recv_us: float = 0.0
                        ) -> "tuple[int, int, int] | None":
        """Serve a hit straight out of the tiers: pinned cache views go to
        the socket with no userspace assembly (MSG_ZEROCOPY when the conn
        granted it), spill-resident ranges ride sendfile(2) from the spill
        file. Returns (payload, zc, sendfile) byte counts, None for a
        miss; raises OSError with the CONNECTION ALREADY DESTROYED on any
        send failure (a half-sent frame is unrecoverable — the peer sees
        a truncated frame and falls back to its engine)."""
        import os as _os

        n = hi - lo
        if n <= 0 or n + 1 > MAX_FRAME or self._closed:
            return None
        sched = getattr(self._ctx, "scheduler", None)
        try:
            # the grant covers the PLAN (tier lookups + pinning) only —
            # never the sends; what the socket does afterwards is paced by
            # TCP, not by the engine arbiter
            if sched is not None:
                g0 = _ring.now_us() if trace is not None else 0.0
                with sched.grant("peer", n, priority="background"):
                    if trace is not None:
                        self._span(trace, "peer.grant", g0,
                                   _ring.now_us() - g0)
                    c0 = _ring.now_us() if trace is not None else 0.0
                    plan = self._plan_local(path, lo, hi)
            else:
                c0 = _ring.now_us() if trace is not None else 0.0
                plan = self._plan_local(path, lo, hi)
        except Exception:
            return None
        if plan is None:
            return None
        if trace is not None:
            self._span(trace, "peer.copy", c0, _ring.now_us() - c0)
        segs, cache, pinned, spill, sp_pinned = plan
        zc0 = zstate.seq if zstate is not None else 0
        zc_b = sf_b = 0
        s0 = _ring.now_us() if trace is not None else 0.0
        tr = (_TRACED_RESP.pack(recv_us, s0) if trace is not None else b"")
        try:
            try:
                conn.sendall(_LEN.pack(1 + len(tr) + n)
                             + bytes([ST_HIT]) + tr)
                for kind, a, off, ln in segs:
                    if kind == "mem":
                        mv = memoryview(a)
                        if zstate is not None and ln >= _ZC_MIN_SEND:
                            self._send_view_zc(conn, mv, zstate)
                        else:
                            conn.sendall(mv)
                        zc_b += ln
                    else:
                        while ln > 0:
                            k = _os.sendfile(conn.fileno(), a, off, ln)
                            if k <= 0:
                                raise OSError(5, "sendfile stalled")
                            off += k
                            ln -= k
                            sf_b += k
                if zstate is not None and zstate.seq > zc0 \
                        and not self._drain_zc(conn, zstate,
                                               time.monotonic() + 2.0):
                    raise OSError(110, "zerocopy completion timeout")
            except OSError:
                # un-acked MSG_ZEROCOPY sends may still reference the
                # pinned pages: destroy the socket FIRST (close frees the
                # skbs), unpin in the finally below, then tell the caller
                # the conn is gone
                with contextlib.suppress(OSError):
                    conn.close()
                raise
        finally:
            cache.unpin(pinned)
            if spill is not None:
                spill.unpin(sp_pinned)
        with self._lock:
            self.zc_bytes += zc_b
            self.sendfile_bytes += sf_b
        if trace is not None:
            self._span(trace, "peer.send", s0, _ring.now_us() - s0)
        return (n, zc_b, sf_b)

    def _send_view_zc(self, conn: socket.socket, mv: memoryview,
                      zstate: "_ZcState") -> None:
        """One view via MSG_ZEROCOPY, falling back to plain sends when the
        kernel runs out of zerocopy budget (ENOBUFS is documented as 'try
        again without the flag', not an error)."""
        sent = 0
        total = len(mv)
        while sent < total:
            try:
                k = conn.send(mv[sent:], _MSG_ZEROCOPY)
            except InterruptedError:
                continue
            except OSError as e:
                if e.errno == 105:  # ENOBUFS: zc budget exhausted
                    conn.sendall(mv[sent:])
                    return
                raise
            zstate.seq += 1
            sent += k

    def _drain_zc(self, conn: socket.socket, zstate: "_ZcState",
                  deadline: float) -> bool:
        """Reap MSG_ERRQUEUE completion notifications until every zc send
        on this conn is acknowledged (the kernel has dropped its page
        references) or *deadline*. sock_extended_err carries an inclusive
        [ee_info, ee_data] sequence range per notification."""
        nonblock = _MSG_ERRQUEUE | getattr(socket, "MSG_DONTWAIT", 0x40)
        while zstate.acked < zstate.seq:
            if time.monotonic() >= deadline:
                return False
            try:
                _msg, ancdata, _flags, _addr = conn.recvmsg(0, 512, nonblock)
            except (BlockingIOError, InterruptedError):
                time.sleep(0.001)
                continue
            except OSError:
                return False
            for _level, _type, data in ancdata:
                if len(data) >= 16:
                    (_eerrno, origin, _t, _c, _p, _info,
                     dat) = struct.unpack_from("IBBBBII", data)
                    if origin == 5:  # SO_EE_ORIGIN_ZEROCOPY
                        zstate.acked = max(zstate.acked, dat + 1)
        return True

    def _read_traced(self, path: str, lo: int, hi: int,
                     trace: "dict | None") -> "np.ndarray | None":
        if trace is None:
            return self._read_local(path, lo, hi)
        c0 = _ring.now_us()
        try:
            return self._read_local(path, lo, hi)
        finally:
            self._span(trace, "peer.copy", c0, _ring.now_us() - c0)

    def _read_local(self, path: str, lo: int, hi: int
                    ) -> "np.ndarray | None":
        cache = getattr(self._ctx, "hot_cache", None)
        if cache is None or not cache.enabled:
            return None
        n = hi - lo
        out = np.empty(n, np.uint8)
        hits, misses, pinned = cache.lookup(path, lo, hi, record=False)
        try:
            for s, t, view in hits:
                out[s - lo: t - lo] = view
            if misses:
                spill = cache.spill
                if spill is None:
                    return None
                for s, t in misses:
                    sp_hits, sp_misses = spill.lookup(path, s, t,
                                                      record=False)
                    try:
                        if sp_misses:
                            return None
                        for ss, tt, ent in sp_hits:
                            spill.read_into(ent, ss, tt,
                                            out[ss - lo: tt - lo])
                    finally:
                        spill.unpin([e for _, _, e in sp_hits])
        finally:
            cache.unpin(pinned)
        return out

    # -- introspection / lifecycle ------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"peer_served_bytes": self.served_bytes,
                    "peer_serves": self.serves,
                    "peer_serves_traced": self.serves_traced,
                    "peer_serve_misses": self.serve_misses,
                    "peer_batch_serves": self.batch_serves,
                    "peer_auth_rejects": self.auth_rejects,
                    "peer_frame_serves": self.frame_serves,
                    "peer_frame_served_bytes": self.frame_served_bytes,
                    "peer_frame_serve_misses": self.frame_serve_misses,
                    "peer_zc_bytes": self.zc_bytes,
                    "peer_sendfile_bytes": self.sendfile_bytes,
                    "peer_copy_bytes": self.copy_bytes,
                    "peer_comp_bytes_in": self.comp_bytes_in,
                    "peer_comp_bytes_out": self.comp_bytes_out,
                    "peer_comp_fallbacks": self.comp_fallbacks,
                    "peer_comp_ratio":
                        round(self.comp_bytes_in / self.comp_bytes_out, 4)
                        if self.comp_bytes_out else 0.0}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # shutdown() before close(): close() alone does NOT wake a thread
        # blocked in accept(), which would keep the kernel listener alive
        # (the port stays bound, a same-addr restart gets EADDRINUSE) and
        # stall this join until its timeout
        with contextlib.suppress(OSError):
            self._sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self._sock.close()
        self._accept.join(timeout=5)


class _PeerState:
    """Client-side per-peer state: a pool of persistent connections
    (checked out under the tier lock, used outside it), a circuit
    breaker, the per-wire-generation verdicts and the running
    clock-offset estimate."""

    __slots__ = ("addr", "pool", "live", "breaker", "trace_ok", "comp_ok",
                 "batch_ok", "offset_us", "rtt_scope")

    def __init__(self, addr: str, breaker: CircuitBreaker, rtt_scope):
        self.addr = addr
        # idle pooled connections + the count of pooled conns in existence
        # (idle or checked out); a failed conn is discarded and live
        # decremented, so a restarted peer gets fresh re-probed conns
        self.pool: "list[socket.socket]" = []
        self.live = 0
        self.breaker = breaker
        # None = untried, True = peer answered a batch op, False = peer
        # dropped one (v1 wire) — downgraded to single-extent ops forever
        # (the newest-wire-downgrades-first ladder: batch → comp → traced)
        self.batch_ok: "bool | None" = None
        # None = untried, True = peer answered a traced request, False =
        # peer dropped one (old wire) — downgraded to plain OP_GET forever
        self.trace_ok: "bool | None" = None
        # same latch for the compressed-capable ops: the first
        # dropped comp request downgrades this peer to uncompressed ops
        # forever, trace verdict untouched (comp downgrades BEFORE trace
        # on a shared failure — comp ops are the newer wire)
        self.comp_ok: "bool | None" = None
        # EWMA of (peer ring clock - our ring clock), microseconds, from
        # the NTP-style four-timestamp estimate each traced exchange carries
        self.offset_us: "float | None" = None
        # per-peer-address scoped series: peer_rtt writes fan to this
        # scope AND the registry aggregate, so /metrics shows one labeled
        # latency series per peer under the unchanged aggregate sum
        self.rtt_scope = rtt_scope


class PeerTier:
    """The peer tier of the delivery consult: RAM → spill → PEERS → engine.

    *peers* maps a peer name (any stable id — the launcher uses the rank)
    to a ``host:port`` address; *owner_fn* maps a dataset path to the
    name of the peer expected to have it hot (the launcher derives it
    from the same ``assign_balanced`` shard ownership every process
    computes), or None for "nobody — go to the engine". Without an
    *owner_fn* every fetch is a miss: directory-less probing of N-1 peers
    per range would be chatter, not a cache.

    Failure contract: :meth:`fetch` returns the bytes or None, NEVER
    raises — a refused connect, timeout, hangup or truncated frame counts
    ``peer_errors``, feeds that peer's breaker, and the caller reads the
    range from its local engine. An OPEN breaker short-circuits to None
    (``peer_skips``) until its cooldown elapses; a half-open probe rides
    a real fetch.
    """

    def __init__(self, peers: "Mapping[object, str] | Sequence[str]", *,
                 owner_fn: "Callable[[str], object] | None" = None,
                 directory=None, scope=None, timeout_s: float = 0.5,
                 plan=None, clock: Callable[[], float] = time.monotonic,
                 breaker_kwargs: "dict | None" = None,
                 compress: bool = False, batch_max_extents: int = 64,
                 conn_pool_size: int = 2, auth_key: str = ""):
        from strom_torch.utils.stats import global_stats

        if not isinstance(peers, Mapping):
            peers = {a: a for a in peers}
        self._scope = scope if scope is not None else global_stats
        self._owner_fn = owner_fn
        # fabric v2: a live ExtentDirectory outranks the static
        # owner_fn — ownership then tracks membership epochs, and a peer
        # whose breaker trips is published dead so the whole fleet re-owns
        # its keys within one directory poll
        self._directory = directory
        self._timeout = float(timeout_s)
        self._plan = plan
        self._batch_max = max(int(batch_max_extents), 0)
        self._pool_size = max(int(conn_pool_size), 1)
        self._auth_key = str(auth_key or "")
        # fetch-side compression ask: advertise our codec on
        # the wire; the server still decides per response (raw when it
        # doesn't pay). Off = the plain wire, byte for byte.
        self._codec = default_codec() if compress else None
        self._lock = make_lock("dist.peer")
        self._closed = False
        self.breaker_trips = 0
        bk = dict(window_s=5.0, min_events=4, error_rate=0.5,
                  cooldown_s=1.0, half_open_successes=2)
        bk.update(breaker_kwargs or {})
        self._peers: dict = {}
        for name, addr in peers.items():
            br = CircuitBreaker(name=f"peer:{addr}", clock=clock,
                                on_trip=(lambda note, _n=name:
                                         self._on_trip(_n, note)), **bk)
            self._peers[name] = _PeerState(
                str(addr), br, self._scope.scoped(peer=str(addr)))
        # tallies (authoritative for stats(); mirrored into the scope)
        self.hit_bytes = 0
        self.hits = 0
        self.misses = 0
        self.errors = 0
        self.skips = 0
        self.fetch_traced = 0
        # fabric v2 tallies: batch/RTT accounting, conn pool churn and
        # decoded-frame fetches
        self.batches = 0
        self.batch_extents = 0
        self.rtt_us_accum = 0.0
        self.rtt_extents = 0
        self.conn_opens = 0
        self.conn_reuses = 0
        self.frame_hits = 0
        self.frame_misses = 0
        self.frame_hit_bytes = 0

    def _on_trip(self, name, note: str) -> None:
        with self._lock:
            self.breaker_trips += 1
        self._scope.add("peer_breaker_trips")
        # a tripped peer is presumed dead: publish it to the directory so
        # every host re-owns its keys at the next membership poll (the
        # window in between shows up as peer_skips — the breaker keeps
        # those probes cheap, the engine fallback keeps them correct)
        if self._directory is not None:
            self._directory.mark_dead(name)

    # -- live-tunable knobs ------
    @property
    def batch_max_extents(self) -> int:
        return self._batch_max

    @batch_max_extents.setter
    def batch_max_extents(self, v: int) -> None:
        self._batch_max = max(int(v), 0)

    @property
    def conn_pool_size(self) -> int:
        return self._pool_size

    @conn_pool_size.setter
    def conn_pool_size(self, v: int) -> None:
        # growing takes effect at the next checkout; shrinking only stops
        # NEW pooled conns — existing ones drain through reuse untouched
        self._pool_size = max(int(v), 1)

    # -- the consult's probe -------------------------------------------------
    def _owner(self, path: str):
        """The owning peer's name for *path*: the live directory when one
        is attached (membership-epoch aware), else the static owner_fn."""
        if self._directory is not None:
            return self._directory.owner(path)
        return self._owner_fn(path) if self._owner_fn is not None else None

    def _precheck(self, path: str, lo: int, hi: int) -> "_PeerState | None":
        """Owner lookup + breaker gate + fault injection for one range —
        the shared front half of fetch()/fetch_many(). Returns the peer
        to ask, or None (no owner / breaker open / injected fault, each
        already counted)."""
        n = hi - lo
        # +1: a hit response is status byte + payload in ONE frame, so the
        # largest servable range is one byte under the frame cap
        if n <= 0 or n + 1 > MAX_FRAME or self._closed:
            return None
        name = self._owner(path)
        st = self._peers.get(name) if name is not None else None
        if st is None:
            return None
        if not st.breaker.allow():
            with self._lock:
                self.skips += 1
            self._scope.add("peer_skips")
            return None
        # network fault injection: peer-op rules of
        # the context's fault plan decide here, in op order on the shared
        # plan RNG — refused connect / mid-stream hangup / truncated frame
        # produce the real outcome (a counted failure + breaker feed +
        # engine fallback) without damaging a live socket; a latency spike
        # delays the real fetch.
        fault = None
        if self._plan is not None:
            fault = self._plan.decide(path=path, offset=lo, length=n,
                                      op="peer")
        if fault is not None and fault.kind == "latency":
            time.sleep(fault.latency_s)
            fault = None
        if fault is not None:
            # the injected failure happens BEFORE any checkout, so no
            # pooled slot is held — fail with no conn to discard
            self._fail(st, None)
            return None
        return st

    def fetch(self, path: str, lo: int, hi: int) -> "np.ndarray | None":
        """Bytes [lo, hi) of *path* from the owning peer, or None (miss /
        error / breaker open / no owner). The returned array is read-only;
        callers copy it into their dest."""
        st = self._precheck(path, lo, hi)
        if st is None:
            return None
        return self._fetch_one(st, path, lo, hi)

    def fetch_many(self, ranges: "Sequence[tuple[str, int, int]]"
                   ) -> "list[np.ndarray | None]":
        """Batched probe for a gather's worth of ranges: resolve owners,
        group per peer, and ride each group over the batch wire in
        pipelined chunks of ``dist_batch_max_extents`` — ONE round trip
        per chunk instead of per extent. Results align with *ranges*
        (None = miss / error / no owner, exactly fetch()'s contract).
        Groups of one range — and every range when batching is off or the
        peer is a v1 server — take the single-extent path, so the
        zc/traced/comp wire and the fault-plan op order are unchanged
        wherever batching cannot help."""
        out: "list[np.ndarray | None]" = [None] * len(ranges)
        groups: dict = {}
        for i, (path, lo, hi) in enumerate(ranges):
            st = self._precheck(path, lo, hi)
            if st is not None:
                groups.setdefault(id(st), (st, []))[1].append(
                    (i, path, lo, hi))
        for st, items in groups.values():
            if (len(items) == 1 or self._batch_max <= 0
                    or st.batch_ok is False):
                for i, path, lo, hi in items:
                    out[i] = self._fetch_one(st, path, lo, hi)
                continue
            served = self._batch_group(st, items)
            for i, path, lo, hi in items:
                if i in served:
                    out[i] = served[i]
                else:
                    # the batch died before this item's response came
                    # back: the single-extent fallback keeps the gather
                    # correct (batch_ok latched, so no retry loop)
                    out[i] = self._fetch_one(st, path, lo, hi)
        return out

    # -- connection pool ------------------------------------------
    def _checkout(self, st: _PeerState
                  ) -> "tuple[socket.socket | None, bool]":
        """A connection to *st*, preferring the pool: ``(sock, pooled)``.
        *sock* None = the caller opens one; pooled = it owns a pool slot
        and is checked back in after use, else overflow beyond
        ``dist_conn_pool_size`` rides an ephemeral conn (closed after
        use) so concurrent gathers never queue on a socket."""
        with self._lock:
            if st.pool:
                sock = st.pool.pop()
                self.conn_reuses += 1
            else:
                sock = None
                if st.live >= self._pool_size:
                    return None, False
                st.live += 1
        if sock is not None:
            self._scope.add("peer_conn_reuses")
        return sock, True

    def _open_conn(self, st: _PeerState) -> socket.socket:
        """Fresh connection to *st* — TCP_NODELAY, counted peer_conn_opens,
        and the shared-key handshake when ``dist_auth_key`` is set (a
        refusal raises and is counted like any other peer error)."""
        host, port = split_addr(st.addr)
        sock = socket.create_connection((host, port),
                                        timeout=self._timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self.conn_opens += 1
            self._scope.add("peer_conn_opens")
            if self._auth_key:
                sock.settimeout(self._timeout)
                send_frame(sock, bytes([OP_AUTH]))
                nonce = recv_frame(sock, max_len=1024)
                mac = hmac.new(self._auth_key.encode("utf-8"),
                               bytes(nonce), hashlib.sha256).digest()
                send_frame(sock, mac)
                verdict = recv_frame(sock, max_len=16)
                if not verdict or verdict[0] != ST_AUTH_OK:
                    raise PeerProtocolError("peer refused auth")
        except BaseException:
            with contextlib.suppress(OSError):
                sock.close()
            raise
        return sock

    def _checkin(self, st: _PeerState, sock: socket.socket,
                 pooled: bool) -> None:
        with self._lock:
            if pooled and not self._closed:
                st.pool.append(sock)
                return
            if pooled:
                st.live -= 1
        with contextlib.suppress(OSError):
            sock.close()

    def _fetch_one(self, st: _PeerState, path: str, lo: int, hi: int
                   ) -> "np.ndarray | None":
        """One single-extent exchange on a pooled (or overflow ephemeral)
        connection — the transport half of :meth:`fetch`."""
        n = hi - lo
        sock, pooled = self._checkout(st)
        # trace propagation: carry the live request's identity
        # plus a fleet-unique flow id over the wire unless this peer has
        # already proven it speaks the old protocol
        req = _request.current() if st.trace_ok is not False else None
        traced = st.trace_ok is not False
        # compression ask: same first-failure downgrade latch
        # as trace_ok, tried independently — a comp-refusing old peer can
        # still speak the traced wire
        use_comp = self._codec is not None and st.comp_ok is not False
        wire_codec = self._codec.name if use_comp else None
        flow_id = next(_flow_ids) if traced else 0
        t0 = time.perf_counter()
        t_send = 0.0
        try:
            if sock is None:
                sock = self._open_conn(st)
            sock.settimeout(self._timeout)
            if traced:
                t_send = _ring.now_us()
                send_frame(sock, encode_request(
                    path, lo, hi,
                    trace=(req.id if req is not None else 0, flow_id,
                           t_send, req.kind if req is not None else ""),
                    codec=wire_codec))
                # flow start lands just after t_send — inside the
                # peer.fetch slice emitted below, which is what binds it
                _ring.flow("s", flow_id, "peer.req", "reqx")
            else:
                send_frame(sock, encode_request(path, lo, hi,
                                                codec=wire_codec))
            payload = recv_frame(sock)
        except (OSError, PeerProtocolError, ValueError):
            # first-attempt downgrade ladder, newest wire first: a comp
            # op that died latches comp_ok (trace verdict untouched —
            # retry traced-uncompressed next); only a comp-free traced
            # failure blames the traced op itself
            if use_comp and st.comp_ok is None:
                st.comp_ok = False
            elif traced and st.trace_ok is None:
                # first traced attempt died: assume an old peer dropped
                # the unknown op and downgrade — one counted error, every
                # later fetch goes plain OP_GET
                st.trace_ok = False
            self._fail(st, sock, pooled=pooled)
            return None
        t_recv = _ring.now_us()
        rtt_us = (time.perf_counter() - t0) * 1e6
        hdr = 1 + (_TRACED_RESP.size if traced else 0)
        status = payload[0] if payload else -1
        if status == ST_HIT and len(payload) == hdr + n:
            data = np.frombuffer(payload, np.uint8, count=n, offset=hdr)
        elif (status == ST_HIT_COMP and use_comp
              and len(payload) > hdr + _RAW_LEN.size):
            # compressed hit: raw_len u64 + codec payload after the
            # normal header; decompressed length must equal the asked
            # range exactly or the frame is untrusted like any other
            # wrong-length hit
            (raw_n,) = _RAW_LEN.unpack_from(payload, hdr)
            try:
                raw = self._codec.decompress(
                    bytes(payload[hdr + _RAW_LEN.size:]))
            except Exception:
                # undecodable payload = corrupt frame: fail the peer
                # exactly like a wrong-length hit
                self._fail(st, sock, pooled=pooled)
                return None
            if raw_n != n or len(raw) != n:
                self._fail(st, sock, pooled=pooled)
                return None
            data = np.frombuffer(raw, np.uint8, count=n)
        elif status == ST_MISS and len(payload) == hdr:
            data = None
        else:
            # wrong-length hit = a truncated/corrupt frame that happened
            # to parse: never trust it
            self._fail(st, sock, pooled=pooled)
            return None
        self._checkin(st, sock, pooled)
        with self._lock:
            if data is None:
                self.misses += 1
            else:
                self.hits += 1
                self.hit_bytes += n
            if traced:
                self.fetch_traced += 1
            self.rtt_us_accum += rtt_us
            self.rtt_extents += 1
        st.breaker.record_success()
        if use_comp:
            st.comp_ok = True
        if traced:
            st.trace_ok = True
            self._finish_traced(st, payload, flow_id, t_send, t_recv,
                                rtt_us, n, req)
        st.rtt_scope.observe_us("peer_rtt", rtt_us)
        if data is None:
            self._scope.add("peer_misses")
        else:
            self._scope.add("peer_hits")
            self._scope.add("peer_hit_bytes", n)
        if traced:
            self._scope.add("peer_fetch_traced")
        return data

    # -- batched transport ----------------------------------------
    def _batch_group(self, st: _PeerState, items: list) -> dict:
        """One owner's items over the batch wire, chunked to
        ``dist_batch_max_extents`` and PIPELINED: chunk k+1's request
        frame is on the wire before chunk k's responses drain, so the
        server never idles between chunks and the stream surfaces as
        instant completions. Returns ``{index: data}`` for every item
        whose response arrived (data None = a served miss); an absent
        index means the transport died first — the caller falls back per
        extent. A first-batch failure latches ``batch_ok`` (trace/comp
        verdicts untouched: the v1 single-extent wire may still be
        fine)."""
        served: dict = {}
        sock, pooled = self._checkout(st)
        traced = st.trace_ok is not False
        use_comp = self._codec is not None and st.comp_ok is not False
        wire_codec = self._codec.name if use_comp else None
        chunks = [items[k: k + self._batch_max]
                  for k in range(0, len(items), self._batch_max)]
        sent: list = []

        def _send(chunk):
            req = _request.current() if traced else None
            flow_id = next(_flow_ids) if traced else 0
            t0 = time.perf_counter()
            t_send = 0.0
            tr = None
            if traced:
                t_send = _ring.now_us()
                tr = (req.id if req is not None else 0, flow_id, t_send,
                      req.kind if req is not None else "")
            send_frame(sock, encode_batch_request(
                [(path, lo, hi) for _, path, lo, hi in chunk],
                trace=tr, codec=wire_codec))
            if traced:
                _ring.flow("s", flow_id, "peer.req", "reqx")
            sent.append((chunk, t0, t_send, flow_id, req))

        hdr = 1 + (_TRACED_RESP.size if traced else 0)
        try:
            if sock is None:
                sock = self._open_conn(st)
            sock.settimeout(self._timeout)
            _send(chunks[0])
            for k in range(len(chunks)):
                if k + 1 < len(chunks):
                    _send(chunks[k + 1])
                chunk, t0, t_send, flow_id, req = sent[k]
                chunk_bytes = 0
                first_tr = None
                for i, path, lo, hi in chunk:
                    n = hi - lo
                    payload = recv_frame(sock)
                    status = payload[0] if payload else -1
                    if status == ST_HIT and len(payload) == hdr + n:
                        data = np.frombuffer(payload, np.uint8, count=n,
                                             offset=hdr)
                    elif (status == ST_HIT_COMP and use_comp
                          and len(payload) > hdr + _RAW_LEN.size):
                        (raw_n,) = _RAW_LEN.unpack_from(payload, hdr)
                        try:
                            raw = self._codec.decompress(
                                bytes(payload[hdr + _RAW_LEN.size:]))
                        except Exception as e:
                            raise PeerProtocolError(
                                f"undecodable batch item: {e}") from e
                        if raw_n != n or len(raw) != n:
                            raise PeerProtocolError(
                                "batch item length mismatch")
                        data = np.frombuffer(raw, np.uint8, count=n)
                    elif status == ST_MISS and len(payload) == hdr:
                        data = None
                    else:
                        raise PeerProtocolError("bad batch item frame")
                    if traced and first_tr is None:
                        first_tr = _TRACED_RESP.unpack_from(payload, 1)
                    served[i] = data
                    if data is not None:
                        chunk_bytes += n
                self._account_chunk(st, chunk, served, chunk_bytes,
                                    (time.perf_counter() - t0) * 1e6,
                                    traced, first_tr, t_send,
                                    _ring.now_us(), flow_id, req)
        except (OSError, PeerProtocolError, ValueError):
            if st.batch_ok is None:
                st.batch_ok = False
            self._fail(st, sock, pooled=pooled)
            return served
        st.batch_ok = True
        if traced:
            st.trace_ok = True
        if use_comp:
            st.comp_ok = True
        self._checkin(st, sock, pooled)
        st.breaker.record_success()
        return served

    def _account_chunk(self, st: _PeerState, chunk, served: dict,
                       chunk_bytes: int, rtt_us: float, traced: bool,
                       first_tr, t_send: float, t_recv: float,
                       flow_id: int, req) -> None:
        """Tallies + trace epilogue for one drained batch chunk: the
        accounting is item-for-item identical to N single fetches, plus
        one peer_batches tick and ONE rtt observation (the chunk IS one
        round trip — which is the whole claim peer_rtt_per_extent_us
        quantifies)."""
        nhit = sum(1 for i, _, _, _ in chunk if served[i] is not None)
        nmiss = len(chunk) - nhit
        with self._lock:
            self.hits += nhit
            self.misses += nmiss
            self.hit_bytes += chunk_bytes
            self.batches += 1
            self.batch_extents += len(chunk)
            self.rtt_us_accum += rtt_us
            self.rtt_extents += len(chunk)
            if traced:
                self.fetch_traced += len(chunk)
        st.rtt_scope.observe_us("peer_rtt", rtt_us)
        if nhit:
            self._scope.add("peer_hits", nhit)
            self._scope.add("peer_hit_bytes", chunk_bytes)
        if nmiss:
            self._scope.add("peer_misses", nmiss)
        self._scope.add("peer_batches")
        self._scope.add("peer_batch_extents", len(chunk))
        if not traced:
            return
        self._scope.add("peer_fetch_traced", len(chunk))
        if first_tr is None:
            return
        t2, t3 = first_tr
        off = ((t2 - t_send) + (t3 - t_recv)) / 2.0
        st.offset_us = off if st.offset_us is None \
            else 0.7 * st.offset_us + 0.3 * off
        _ring.flow("f", flow_id, "peer.req", "reqx")
        args = {"peer": st.addr, "extents": len(chunk),
                "bytes": chunk_bytes, "flow": flow_id}
        if req is not None:
            req.record("peer.fetch", "dist", t_send, t_recv - t_send,
                       args, parent=req.parent_of())
        else:
            _ring.complete(t_send, t_recv - t_send, "dist", "peer.fetch",
                           args)

    # -- decoded-frame fetch --------------------------------------
    def fetch_frame(self, path: str, lo: int, hi: int,
                    fingerprint: "str | None" = None
                    ) -> "np.ndarray | None":
        """One decoded frame (``(h, w, 3)`` uint8 RGB) out of the owning
        peer's DecodedCache, or None. Rides a one-key kind-1 batch frame
        on the pooled conn — a v1 peer (batch_ok False) is never asked,
        and frame bytes are tallied apart from extent bytes."""
        if self._closed or self._batch_max <= 0:
            return None
        name = self._owner(path)
        st = self._peers.get(name) if name is not None else None
        if st is None or st.batch_ok is False:
            return None
        if not st.breaker.allow():
            with self._lock:
                self.skips += 1
            self._scope.add("peer_skips")
            return None
        sock, pooled = self._checkout(st)
        t0 = time.perf_counter()
        try:
            if sock is None:
                sock = self._open_conn(st)
            sock.settimeout(self._timeout)
            send_frame(sock, encode_batch_request(
                [(path, lo, hi, fingerprint or "")]))
            payload = recv_frame(sock)
        except (OSError, PeerProtocolError, ValueError):
            if st.batch_ok is None:
                st.batch_ok = False
            self._fail(st, sock, pooled=pooled)
            return None
        rtt_us = (time.perf_counter() - t0) * 1e6
        status = payload[0] if payload else -1
        img = None
        if status == ST_HIT and len(payload) >= 1 + _DIMS.size:
            h, w = _DIMS.unpack_from(payload, 1)
            nb = len(payload) - 1 - _DIMS.size
            if nb != h * w * 3:
                self._fail(st, sock, pooled=pooled)
                return None
            img = np.frombuffer(payload, np.uint8, count=nb,
                                offset=1 + _DIMS.size).reshape(h, w, 3)
        elif not (status == ST_MISS and len(payload) == 1):
            self._fail(st, sock, pooled=pooled)
            return None
        st.batch_ok = True
        self._checkin(st, sock, pooled)
        st.breaker.record_success()
        st.rtt_scope.observe_us("peer_rtt", rtt_us)
        with self._lock:
            if img is None:
                self.frame_misses += 1
            else:
                self.frame_hits += 1
                self.frame_hit_bytes += img.nbytes
        if img is None:
            self._scope.add("peer_frame_misses")
        else:
            self._scope.add("peer_frame_hits")
            self._scope.add("peer_frame_hit_bytes", img.nbytes)
        return img

    def _finish_traced(self, st: _PeerState, payload, flow_id: int,
                       t_send: float, t_recv: float, rtt_us: float,
                       n: int, req) -> None:
        """Trace epilogue of one traced exchange: fold the server's two
        echoed timestamps into the peer's clock-offset EWMA (NTP-style:
        offset = ((t2-t1)+(t3-t4))/2, each side on its own ring timebase),
        close the flow arrow, and emit the client-side ``peer.fetch`` span
        — billed under the live request when one is active."""
        t2, t3 = _TRACED_RESP.unpack_from(payload, 1)
        off = ((t2 - t_send) + (t3 - t_recv)) / 2.0
        st.offset_us = off if st.offset_us is None \
            else 0.7 * st.offset_us + 0.3 * off
        _ring.instant("peer.clock_offset", cat="dist",
                      args={"peer": st.addr,
                            "offset_us": round(st.offset_us, 1),
                            "rtt_us": round(rtt_us, 1)})
        _ring.flow("f", flow_id, "peer.req", "reqx")
        args = {"peer": st.addr, "bytes": n, "flow": flow_id}
        if req is not None:
            req.record("peer.fetch", "dist", t_send, t_recv - t_send,
                       args, parent=req.parent_of())
        else:
            _ring.complete(t_send, t_recv - t_send, "dist", "peer.fetch",
                           args)

    def _fail(self, st: _PeerState, sock: "socket.socket | None", *,
              pooled: bool = False) -> None:
        if sock is not None:
            with contextlib.suppress(OSError):
                sock.close()
        with self._lock:
            if pooled:
                # a failed pooled conn is DISCARDED, never re-pooled: the
                # freed slot makes the next fetch open (and re-auth) a
                # fresh connection, so a restarted peer is re-probed
                # immediately and stale sockets never linger
                st.live -= 1
            self.errors += 1
        st.breaker.record_failure()
        self._scope.add("peer_errors")

    # -- introspection / lifecycle ------------------------------------------
    def peers_info(self) -> dict:
        out = {}
        for name, st in self._peers.items():
            out[str(name)] = {"addr": st.addr, "trace_ok": st.trace_ok,
                              "comp_ok": st.comp_ok,
                              "batch_ok": st.batch_ok,
                              "pooled_conns": st.live,
                              "clock_offset_us":
                                  None if st.offset_us is None
                                  else round(st.offset_us, 1),
                              **st.breaker.info()}
        return out

    def stats(self) -> dict:
        # rtt writes land in per-peer-ADDRESS scopes (one labeled series
        # per peer), so this tier's own latency view is the bucket-merge
        # of exactly its peers' scopes — never the process-global
        # aggregate: two peered contexts in one process (daemon mode)
        # must not read each other's latencies into their dist sections
        from strom_torch.utils.stats import _Histogram

        h = _Histogram()
        for st in self._peers.values():
            sh = st.rtt_scope.histogram("peer_rtt")
            h.add_buckets(sh.buckets, sh.total_us)
        open_peers = sum(1 for st in self._peers.values()
                         if st.breaker.state == CircuitBreaker.OPEN)
        with self._lock:
            reuse_denom = self.conn_opens + self.conn_reuses
            out = {
                "peer_hit_bytes": self.hit_bytes,
                "peer_hits": self.hits,
                "peer_misses": self.misses,
                "peer_errors": self.errors,
                "peer_skips": self.skips,
                "peer_fetch_traced": self.fetch_traced,
                "peer_breaker_trips": self.breaker_trips,
                "peer_batches": self.batches,
                "peer_batch_extents": self.batch_extents,
                "peer_rtt_per_extent_us":
                    round(self.rtt_us_accum / self.rtt_extents, 1)
                    if self.rtt_extents else 0.0,
                "peer_conn_opens": self.conn_opens,
                "peer_conn_reuses": self.conn_reuses,
                "peer_conn_reuse_ratio":
                    round(self.conn_reuses / reuse_denom, 4)
                    if reuse_denom else 0.0,
                "peer_frame_hits": self.frame_hits,
                "peer_frame_misses": self.frame_misses,
                "peer_frame_hit_bytes": self.frame_hit_bytes,
            }
        out["peer_breaker_open"] = open_peers
        out["peer_rtt_p50_us"] = h.percentile(0.50)
        out["peer_rtt_p99_us"] = h.percentile(0.99)
        out["peer_ring_epoch"] = (self._directory.epoch
                                  if self._directory is not None else 0)
        self._scope.set_gauge("peer_breaker_open", open_peers)
        self._scope.set_gauge("peer_rtt_per_extent_us",
                              out["peer_rtt_per_extent_us"])
        self._scope.set_gauge("peer_conn_reuse_ratio",
                              out["peer_conn_reuse_ratio"])
        self._scope.set_gauge("peer_ring_epoch", out["peer_ring_epoch"])
        return out

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            socks = []
            for st in self._peers.values():
                socks.extend(st.pool)
                st.pool.clear()
        for s in socks:
            with contextlib.suppress(OSError):
                s.close()
