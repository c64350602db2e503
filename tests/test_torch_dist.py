"""The port's peer extent service and launcher (``strom_torch/dist``) held
to the JAX package's ``strom/dist``, case by case with
``tests/test_dist.py``, on seeded numpy fixtures:

- the framing and the request codecs: what one package encodes the other
  decodes, to the byte; truncation and the frame cap are refused;
- an extent hot on host A reaches host B with B's engine reading no byte
  (and promotes into B's cache); a miss, a refused connect, a peer killed
  mid-frame and every injected peer fault fall back to B's engine with
  the same bytes; zero-copy serving, from RAM and through sendfile(2) out
  of the spill file; a context without a hot cache still asks its peers;
  the breaker trips and recovers on a fake clock; each scenario run in
  both packages gives the same bytes and the same counters;
- the ``dist`` section's keys are ``DIST_FIELDS``, the reference's;
- the launcher at 2 and 4 host-mode processes: every worker's sha256
  equals the JAX package's ``reference_shard_hashes``, no worker's engine
  reads during ingest, and the peers' hit bytes equal their served bytes;
  ``owner_of``, ``global_row_order`` and the hashes equal the reference's.

Tolerance: exact (bytes, hashes, owners, counters). Every fleet test
passes ``timeout_s`` to the launcher and runs under a time limit of its
own (SIGALRM), and judges by hashes and byte counters only."""

import contextlib
import os
import signal
import socket
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import strom.config as jconfig
import strom.delivery.core as jcore
import strom.dist.launch as jlaunch
import strom.dist.peers as jpeers
import strom.faults.plan as jplan
import strom_torch.config as tconfig
import strom_torch.delivery.core as tcore
import strom_torch.dist.launch as tlaunch
import strom_torch.dist.peers as tpeers
import strom_torch.faults.plan as tplan

PKGS = {
    "jax": SimpleNamespace(Config=jconfig.StromConfig,
                           Context=jcore.StromContext, peers=jpeers,
                           launch=jlaunch, FaultPlan=jplan.FaultPlan,
                           FaultRule=jplan.FaultRule),
    "torch": SimpleNamespace(Config=tconfig.StromConfig,
                             Context=tcore.StromContext, peers=tpeers,
                             launch=tlaunch, FaultPlan=tplan.FaultPlan,
                             FaultRule=tplan.FaultRule),
}
BOTH = sorted(PKGS)
PAIRS = [(a, b) for a in BOTH for b in BOTH]
FLEET_TIMEOUT_S = 60.0


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the test (TimeoutError) once *seconds* have passed."""
    def on_alarm(signum, frame):
        raise TimeoutError(f"over the test's {seconds} s limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _cfg(k, **kw):
    base = dict(engine="python", queue_depth=8, num_buffers=8,
                hot_cache_bytes=64 << 20, hot_cache_admit="always")
    base.update(kw)
    return k.Config(**base)


def _fixture(tmp_path, n=256 * 1024, seed=0, name="data.bin"):
    p = str(tmp_path / name)
    payload = np.random.default_rng(seed).integers(0, 255, n, dtype=np.uint8)
    payload.tofile(p)
    return p, payload


def _wait_stats(server, pred, timeout=5.0):
    """The server tallies a beat after the client has its bytes: poll."""
    deadline = time.monotonic() + timeout
    while True:
        st = server.stats()
        if pred(st) or time.monotonic() >= deadline:
            return st
        time.sleep(0.01)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _engine_read(ctx) -> int:
    return ctx.engine.stats().get("bytes_read", 0)


@contextlib.contextmanager
def _pair(k, cfg_a=None, cfg_b=None):
    """Two contexts of package *k*: A serving, B peered with A (A owns
    every path)."""
    A = k.Context(cfg_a or _cfg(k))
    B = k.Context(cfg_b or _cfg(k))
    try:
        addr = A.serve_peers()
        yield A, B, addr
    finally:
        A.close()
        B.close()


def _both(fn, *args):
    """*fn* run on each package; asserts they observed the same and returns
    the port's observation."""
    got = {name: fn(k, *args) for name, k in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# -- framing and the request codecs -------------------------------------------

REQUESTS = [
    dict(),
    dict(trace=(7, 123456789, 1.5e6, "batch")),
    dict(codec="zlib"),
    dict(trace=(1, 2, 3.25, ""), codec="lz4"),
]


@pytest.mark.parametrize("enc,dec", PAIRS)
@pytest.mark.parametrize("kw", range(len(REQUESTS)))
def test_request_roundtrip(enc, dec, kw):
    """One package encodes, the other decodes: the same bytes either way,
    and the plain op through the strict single-op decoder."""
    E, D = PKGS[enc].peers, PKGS[dec].peers
    kwargs = REQUESTS[kw]
    raw = E.encode_request("/some/path.bin", 4096, 123456, **kwargs)
    assert raw == D.encode_request("/some/path.bin", 4096, 123456, **kwargs)
    path, lo, hi, trace, codec = D.decode_request_ex(raw)
    assert (path, lo, hi, codec) == ("/some/path.bin", 4096, 123456,
                                     kwargs.get("codec"))
    want = kwargs.get("trace")
    assert trace == (None if want is None else dict(
        zip(("req", "flow", "send_us", "parent"), want)))
    if not kwargs:
        assert D.decode_request(raw) == ("/some/path.bin", 4096, 123456)


@pytest.mark.parametrize("pkg", BOTH)
def test_request_rejects_garbage(pkg):
    P = PKGS[pkg].peers
    with pytest.raises(P.PeerProtocolError):
        P.decode_request(b"\x01\x00")
    with pytest.raises(P.PeerProtocolError):
        P.decode_request(P.encode_request("p", 0, 8) + b"extra")
    bad = bytearray(P.encode_request("p", 0, 8))
    bad[0] = 99                       # an op nobody speaks
    with pytest.raises(P.PeerProtocolError):
        P.decode_request(bad)
    with pytest.raises(P.PeerProtocolError):
        P.decode_request_ex(P.encode_request("p", 8, 0))   # hi < lo


def test_wire_constants_match():
    names = ("OP_GET", "OP_GET_TRACED", "OP_GET_COMP", "OP_GET_TRACED_COMP",
             "OP_GET_BATCH", "OP_AUTH", "ST_HIT", "ST_MISS", "ST_HIT_COMP",
             "ST_AUTH_OK", "ST_AUTH_REJECT", "KIND_EXTENT", "KIND_FRAME",
             "AUTH_NONCE_LEN", "MAX_FRAME", "DIST_FIELDS",
             "DIST_BENCH_FIELDS")
    assert {n: getattr(tpeers, n) for n in names} == \
        {n: getattr(jpeers, n) for n in names}


@pytest.mark.parametrize("snd,rcv", PAIRS)
def test_frame_roundtrip_over_socketpair(snd, rcv):
    a, b = socket.socketpair()
    try:
        payload = np.random.default_rng(3).bytes(70000)  # > one segment
        t = threading.Thread(target=PKGS[snd].peers.send_frame,
                             args=(a, [payload[:10], payload[10:]]),
                             name="test-frame-send", daemon=True)
        t.start()
        got = PKGS[rcv].peers.recv_frame(b)
        t.join()
        assert bytes(got) == payload
    finally:
        a.close()
        b.close()


def test_truncated_frame_detected():
    a, b = socket.socketpair()
    try:
        # the header promises 100 bytes, the sender hangs up after 10
        a.sendall(struct.pack("!I", 100) + b"x" * 10)
        a.close()
        with pytest.raises(tpeers.PeerProtocolError):
            tpeers.recv_frame(b)
    finally:
        b.close()


def test_frame_cap_enforced():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", 1 << 31))
        with pytest.raises(tpeers.PeerProtocolError):
            tpeers.recv_frame(b)
    finally:
        a.close()
        b.close()


# -- serving: no second SSD read ----------------------------------------------

def _hit_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    with _pair(k) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)      # warm A (admit always)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        b0 = _engine_read(B)
        got = B.pread(p, 1024, 8192)
        assert bytes(got) == payload[1024:1024 + 8192].tobytes()
        first = _engine_read(B) - b0
        tier = B.peer_tier.stats()
        served = _wait_stats(A.peer_server,
                             lambda s: s["peer_serves"] >= 1)
        # promoted: the next read of the range never leaves B
        got2 = B.pread(p, 1024, 8192)
        assert bytes(got2) == bytes(got)
        return {"engine_delta": first,
                "engine_delta_after": _engine_read(B) - b0,
                "hit_bytes": tier["peer_hit_bytes"],
                "hits_after": B.peer_tier.stats()["peer_hits"],
                "served": served["peer_served_bytes"],
                "serves": served["peer_serves"]}


def test_peer_hit_zero_engine_reads(tmp_path):
    """Extent hot on A, read by B: B's engine reads 0 bytes, in both
    packages, and the range promotes into B's own cache."""
    got = _both(_hit_scenario, tmp_path)
    assert got == {"engine_delta": 0, "engine_delta_after": 0,
                   "hit_bytes": 8192, "hits_after": 1, "served": 8192,
                   "serves": 1}


def _miss_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    with _pair(k) as (A, B, addr):
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        got = B.pread(p, 0, 4096)
        assert bytes(got) == payload[:4096].tobytes()
        st = B.peer_tier.stats()
        sv = _wait_stats(A.peer_server,
                         lambda s: s["peer_serve_misses"] >= 1)
        return {"misses": st["peer_misses"], "errors": st["peer_errors"],
                "serve_misses": sv["peer_serve_misses"]}


def test_peer_miss_falls_back_to_engine(tmp_path):
    """A range the owner does not hold answers miss; B's engine serves it,
    the miss counted, never an error."""
    assert _both(_miss_scenario, tmp_path) == {"misses": 1, "errors": 0,
                                                "serve_misses": 1}


def _zc_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    with _pair(k, cfg_a=_cfg(k, dist_send_zc=True)) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        b0 = _engine_read(B)
        # one send under the MSG_ZEROCOPY threshold, one over it
        for lo, n in ((1024, 8192), (64 << 10, 128 * 1024)):
            got = B.pread(p, lo, n)
            assert bytes(got) == payload[lo:lo + n].tobytes()
        st = _wait_stats(A.peer_server, lambda s: s["peer_serves"] >= 2)
        return {"engine_delta": _engine_read(B) - b0,
                "zc_or_sendfile": st["peer_zc_bytes"]
                + st["peer_sendfile_bytes"],
                "copy": st["peer_copy_bytes"], "serves": st["peer_serves"]}


def test_peer_zc_serve_bit_identical(tmp_path):
    """The zero-copy exporter (``dist_send_zc``) serves the same bytes to an
    unmodified client, counted as zero-copy, never through the bounce."""
    assert _both(_zc_scenario, tmp_path) == {
        "engine_delta": 0, "zc_or_sendfile": 8192 + 128 * 1024, "copy": 0,
        "serves": 2}


def _sendfile_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    # a cache far smaller than the file: the head of the sequential read
    # is demoted to the spill file by the time the tail is admitted
    cfg_a = _cfg(k, hot_cache_bytes=96 << 10, spill_bytes=8 << 20,
                 spill_dir=str(tmp_path), dist_send_zc=True)
    with _pair(k, cfg_a=cfg_a) as (A, B, addr):
        for off in range(0, payload.nbytes, 32 << 10):
            A.pread(p, off, 32 << 10)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        got = B.pread(p, 0, 64 << 10)
        assert bytes(got) == payload[:64 << 10].tobytes()
        st = _wait_stats(A.peer_server, lambda s: s["peer_serves"] >= 1)
        return {"copy": st["peer_copy_bytes"],
                "sendfile_used": st["peer_sendfile_bytes"] > 0,
                "total": st["peer_sendfile_bytes"] + st["peer_zc_bytes"]}


def test_peer_zc_serves_spilled_extents_via_sendfile(tmp_path):
    """A zero-copy server whose extent was demoted to the spill tier ships
    it with sendfile(2): the right bytes, no bounce."""
    assert _both(_sendfile_scenario, tmp_path) == {
        "copy": 0, "sendfile_used": True, "total": 64 << 10}


def _cacheless_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    with _pair(k, cfg_b=_cfg(k, hot_cache_bytes=0)) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        b0 = _engine_read(B)
        got = B.pread(p, 0, 4096)
        assert bytes(got) == payload[:4096].tobytes()
        return {"engine_delta": _engine_read(B) - b0,
                "hit_bytes": B.peer_tier.stats()["peer_hit_bytes"]}


def test_cacheless_context_still_probes_peers(tmp_path):
    """A peered context without a hot cache still asks its peers (the
    consult takes a None cache)."""
    assert _both(_cacheless_scenario, tmp_path) == {"engine_delta": 0,
                                                     "hit_bytes": 4096}


def test_cacheless_streamed_gather_asks_peers(tmp_path):
    """The streamed gather takes the consult's gate: without a hot cache a
    peered context's streamed ranges come from the peer, as instant
    completions, and its engine reads nothing."""
    from strom_torch.delivery.shard import Segment

    k = PKGS["torch"]
    p, payload = _fixture(tmp_path)
    with _pair(k, cfg_b=_cfg(k, hot_cache_bytes=0)) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        b0 = _engine_read(B)
        dest = np.zeros(64 << 10, np.uint8)
        g = B.stream_segments(p, [Segment(0, 0, 64 << 10)], dest)
        try:
            ranges = []
            while not g.done:
                ranges.extend(g.poll(min_completions=1, timeout_s=0.5))
            g.finish()
        finally:
            g.close()
        assert g.instant_bytes == 64 << 10
        assert sorted(ranges) == [(0, 64 << 10)]
        assert bytes(dest) == payload[:64 << 10].tobytes()
        assert _engine_read(B) - b0 == 0


def test_killed_peer_mid_serve_degrades_bit_identical(tmp_path):
    """A peer that dies mid-frame costs one counted error and an engine
    read: the bytes equal a read without peers."""
    p, payload = _fixture(tmp_path)
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    addr = f"127.0.0.1:{lsock.getsockname()[1]}"
    stop = threading.Event()

    def rogue():
        # reads the request, sends part of a promised frame, hangs up
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            try:
                tpeers.recv_frame(conn)
                conn.sendall(struct.pack("!I", 4097) + b"\x00" * 100)
            except (OSError, tpeers.PeerProtocolError):
                pass
            finally:
                conn.close()

    t = threading.Thread(target=rogue, name="test-rogue-peer", daemon=True)
    t.start()
    B = tcore.StromContext(_cfg(PKGS["torch"]))
    try:
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        got = B.pread(p, 0, 4096)
        assert bytes(got) == payload[:4096].tobytes()
        assert B.peer_tier.stats()["peer_errors"] >= 1
    finally:
        stop.set()
        with contextlib.suppress(OSError):
            lsock.shutdown(socket.SHUT_RDWR)   # wakes the accept
        lsock.close()
        B.close()
        t.join(timeout=5)


def test_dead_peer_refused_connect_falls_back(tmp_path):
    p, payload = _fixture(tmp_path)
    B = tcore.StromContext(_cfg(PKGS["torch"]))
    try:
        B.attach_peers({0: f"127.0.0.1:{_free_port()}"},
                       owner_fn=lambda path: 0)
        got = B.pread(p, 0, 4096)
        assert bytes(got) == payload[:4096].tobytes()
        assert B.peer_tier.stats()["peer_errors"] >= 1
    finally:
        B.close()


# -- the breaker on a fake clock -----------------------------------------------

def _breaker_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    port = _free_port()
    now = [1000.0]
    tier = k.peers.PeerTier({0: f"127.0.0.1:{port}"},
                            owner_fn=lambda path: 0, timeout_s=0.2,
                            clock=lambda: now[0],
                            breaker_kwargs=dict(min_events=4, cooldown_s=1.0,
                                                half_open_successes=2))
    A = None
    seen = []
    try:
        for _ in range(4):             # nobody listens: 4 failures trip it
            assert tier.fetch(p, 0, 4096) is None
        st = tier.stats()
        seen.append((st["peer_errors"], st["peer_breaker_trips"],
                     st["peer_breaker_open"]))
        assert tier.fetch(p, 0, 4096) is None     # open: a skip
        st = tier.stats()
        seen.append((st["peer_errors"], st["peer_skips"]))
        A = k.Context(_cfg(k))
        A.serve_peers(port=port)
        A.pread(p, 0, payload.nbytes)
        now[0] += 1.5                  # the cooldown passes
        for _ in range(2):             # two half-open probes close it
            got = tier.fetch(p, 0, 4096)
            assert bytes(got) == payload[:4096].tobytes()
        seen.append((tier.stats()["peer_breaker_open"],
                     next(iter(tier.peers_info().values()))["state"]))
        return seen
    finally:
        tier.close()
        if A is not None:
            A.close()


def test_peer_breaker_trip_and_recovery(tmp_path):
    assert _both(_breaker_scenario, tmp_path) == [(4, 1, 1), (4, 1),
                                                   (0, "closed")]


# -- peer-op faults and chaos_net ----------------------------------------------

def _fault_scenario(k, tmp_path, kind, extra):
    p, payload = _fixture(tmp_path)
    plan = k.FaultPlan([k.FaultRule(kind, op="peer", times=1, **extra)])
    with _pair(k) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        B.peer_tier._plan = plan
        got = B.pread(p, 0, 4096)            # injected failure: the engine
        assert bytes(got) == payload[:4096].tobytes()
        errors = B.peer_tier.stats()["peer_errors"]
        got2 = B.pread(p, 8192, 4096)        # rule spent: a peer hit
        assert bytes(got2) == payload[8192:8192 + 4096].tobytes()
        return {"errors": errors, "hits": B.peer_tier.stats()["peer_hits"]}


@pytest.mark.parametrize("kind,extra", [
    ("errno", {"err": "ECONNREFUSED"}), ("hangup", {}),
    ("short_read", {"short_frac": 0.5})])
def test_peer_fault_kinds_injected(tmp_path, kind, extra):
    """errno, hangup and short_read peer rules each give a counted failure
    and an engine read, then the peer serves again."""
    assert _both(_fault_scenario, tmp_path, kind, extra) == {"errors": 1,
                                                            "hits": 1}


def test_peer_latency_fault_still_serves(tmp_path):
    p, payload = _fixture(tmp_path)
    plan = tplan.FaultPlan([tplan.FaultRule("latency", op="peer", times=1,
                                            latency_s=0.05)])
    with _pair(PKGS["torch"]) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        B.peer_tier._plan = plan
        t0 = time.perf_counter()
        got = B.pread(p, 0, 4096)
        assert time.perf_counter() - t0 >= 0.05
        assert bytes(got) == payload[:4096].tobytes()
        st = B.peer_tier.stats()
        assert (st["peer_hits"], st["peer_errors"]) == (1, 0)


def test_chaos_net_preset_shape_and_spec():
    plan = tplan.FaultPlan.from_spec("chaos_net:7")
    assert plan.seed == 7
    assert all(r.op == "peer" for r in plan.rules)
    assert {r.kind for r in plan.rules} == {"errno", "hangup", "latency",
                                            "short_read"}
    # the same seed over the same ops decides the same, in both packages
    kinds = {}
    for name, k in PKGS.items():
        pl = k.FaultPlan.chaos_net(3)
        kinds[name] = [f and f.kind for f in (
            pl.decide(path="x", offset=0, length=64, op="peer")
            for _ in range(50))]
    assert kinds["torch"] == kinds["jax"]


def test_peer_rules_consume_no_engine_draws():
    """Engine ops interleaved with peer ops do not move the peer fault
    stream (a rule of another op draws nothing)."""
    a, b = tplan.FaultPlan.chaos_net(5), tplan.FaultPlan.chaos_net(5)
    seq_a = []
    for i in range(60):
        if i % 2:
            assert a.decide(path="x", offset=0, length=64, op="read") is None
        else:
            f = a.decide(path="x", offset=0, length=64, op="peer")
            seq_a.append(f and f.kind)
    assert seq_a == [f and f.kind for f in (
        b.decide(path="x", offset=0, length=64, op="peer")
        for _ in range(30))]


def test_chaos_net_pipeline_bit_identical(tmp_path):
    """Reads through chaos_net-injected peer faults deliver the same bytes
    (every injected failure falls to the local engine)."""
    k = PKGS["torch"]
    p, payload = _fixture(tmp_path)
    with _pair(k, cfg_b=_cfg(k, fault_plan="chaos_net:1")) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        out = bytearray()
        for off in range(0, 64 * 1024, 4096):
            out += bytes(B.pread(p, off, 4096))
        assert bytes(out) == payload[: 64 * 1024].tobytes()
        st = B.peer_tier.stats()
        assert st["peer_hits"] + st["peer_errors"] + st["peer_skips"] == 16


def test_hangup_rule_on_engine_op_degrades_to_errno(tmp_path):
    """A hangup rule without a direction that hits an engine op completes
    as a retried errno, never a swallowed completion."""
    p, payload = _fixture(tmp_path)
    plan_doc = '{"rules": [{"kind": "hangup", "times": 1, "err": "EIO"}]}'
    ctx = tcore.StromContext(_cfg(PKGS["torch"], fault_plan=plan_doc,
                                  io_retries=2))
    try:
        assert bytes(ctx.pread(p, 0, 8192)) == payload[:8192].tobytes()
    finally:
        ctx.close()


# -- the dist section ----------------------------------------------------------

def _section_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    with _pair(k) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        B.pread(p, 0, 4096)
        client = B.stats(sections=["dist"])["dist"]
        server = A.stats(sections=["dist"])["dist"]
        C = k.Context(_cfg(k))
        try:
            bare = "dist" in C.stats()
        finally:
            C.close()
        return {"keys": sorted({**client, **server}), "bare": bare,
                "client": sorted(client), "server": sorted(server)}


def test_dist_stats_section_single_sourced(tmp_path):
    """The merged client and server sections hold exactly ``DIST_FIELDS``,
    the same keys as the reference's; a context with neither has none."""
    got = _both(_section_scenario, tmp_path)
    assert got["keys"] == sorted(tpeers.DIST_FIELDS)
    assert not got["bare"]


def test_dist_section_in_the_exposition(tmp_path):
    """The section's counters reach the Prometheus text of the registry
    and of the sections, fed by a peer fetch."""
    import strom_torch
    from strom_torch.utils.stats import sections_prometheus

    k = PKGS["torch"]
    p, payload = _fixture(tmp_path)
    with _pair(k) as (A, B, addr):
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        B.pread(p, 0, 4096)
        text = strom_torch.prometheus()
        assert "strom_peer_hit_bytes" in text
        assert "strom_peer_serves" in text
        secs = sections_prometheus(B.stats(sections=["dist"]))
        assert "peer_hits" in secs


def test_serve_peers_idempotent_and_closed_refused(tmp_path):
    ctx = tcore.StromContext(_cfg(PKGS["torch"]))
    addr = ctx.serve_peers()
    assert ctx.serve_peers() == addr
    ctx.close()
    with pytest.raises(RuntimeError):
        ctx.serve_peers()


# -- the launcher ----------------------------------------------------------------

@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_ingest_bit_identical(tmp_path, nproc):
    """Host-mode fleets: every worker's rows hash to the JAX package's
    reference, the engines read nothing during ingest, each worker
    delivered exactly its own rows, and the peers' hit bytes equal their
    served bytes."""
    data = str(tmp_path / "data")
    tlaunch.make_fixture(data, files=4, records=48, seq_len=16)
    paths = sorted(os.path.join(data, f) for f in os.listdir(data)
                   if f.endswith(".bin"))
    ref = jlaunch.reference_shard_hashes(paths, 16, nproc, 8, 4, seed=0)
    with time_limit(FLEET_TIMEOUT_S + 60):
        results = tlaunch.launch_local(nproc, data, str(tmp_path / "run"),
                                       steps=4, batch=8, seq_len=16, seed=0,
                                       timeout_s=FLEET_TIMEOUT_S)
    assert len(results) == nproc
    for r, res in enumerate(results):
        assert res.get("rc") == 0 and res.get("ok"), \
            f"worker {r}: {res.get('tail', res)}"
        assert res["sha256"] == ref[r], f"worker {r} diverged"
        assert res["engine_ingest_bytes"] == 0, res
        assert res["delivered_bytes"] == res["ingest_bytes"] == 4 * (
            8 // nproc) * 64
        assert res["peer_errors"] == 0, res
    assert sum(r["peer_hit_bytes"] for r in results) > 0
    assert sum(r["peer_hit_bytes"] for r in results) == \
        sum(r["peer_served_bytes"] for r in results)


def test_measure_ingest_fields(tmp_path):
    with time_limit(FLEET_TIMEOUT_S + 60):
        res = tlaunch.measure_ingest(2, str(tmp_path), steps=3, batch=8,
                                     seq_len=16, timeout_s=FLEET_TIMEOUT_S)
    assert res["dist_ok"] == 1, res["workers"]
    assert res["dist_peer_hit_ratio"] > 0
    assert res["dist_engine_ingest_bytes"] == 0
    assert res["dist_only_own_rows"] == 1
    # rank 0's federation saw both workers and their traced serves
    assert res["cluster_hosts"] == 2 and res["cluster_hosts_unhealthy"] == 0
    assert res["cluster_trace_linked_ratio"] > 0
    # every DIST_BENCH_FIELDS column is measured here or derived by the
    # CLI's arm (the single pass and the batched/unbatched A/B)
    arm_derived = {"dist_single_items_per_s", "dist_vs_single",
                   "dist_batch_vs_single", "dist_unbatched_items_per_s"}
    for k in tpeers.DIST_BENCH_FIELDS:
        assert k in res or k in arm_derived, k
    # the reference's columns, and the port's one more
    jkeys = {"dist_ok", "dist_procs", "dist_steps", "dist_items_per_s",
             "dist_peer_hit_ratio", "dist_peer_hit_bytes",
             "dist_peer_served_bytes", "dist_engine_ingest_bytes",
             "dist_peer_comp_bytes_in", "dist_peer_comp_bytes_out",
             "dist_peer_wire_bytes", "peer_comp_ratio",
             "dist_assembly_wait_p99_us", "dist_peer_rtt_p99_us",
             "peer_rtt_per_extent_us", "peer_frame_hit_bytes",
             "peer_conn_reuse_ratio", "workers"}
    assert jkeys <= set(res)


@pytest.mark.parametrize("seed", [0, 3])
def test_owner_map_deterministic_and_balanced(tmp_path, seed):
    """``owner_of``, ``global_row_order``, ``dataset_layout`` and
    ``reference_shard_hashes`` equal the reference's."""
    data = str(tmp_path / "data")
    paths = tlaunch.make_fixture(data, files=6, records=30 + seed,
                                 seq_len=16, seed=seed)
    jpaths = jlaunch.make_fixture(str(tmp_path / "j"), files=6,
                                  records=30 + seed, seq_len=16, seed=seed)
    assert [open(a, "rb").read() for a in paths] == \
        [open(b, "rb").read() for b in jpaths]
    o1, o2 = tlaunch.owner_of(paths, 3), tlaunch.owner_of(paths, 3)
    assert o1 == o2 == jlaunch.owner_of(paths, 3)
    assert set(o1.values()) == {0, 1, 2}
    np.testing.assert_array_equal(tlaunch.global_row_order(180, 400, seed),
                                  jlaunch.global_row_order(180, 400, seed))
    tl, jl = (m.dataset_layout(paths, 16) for m in (tlaunch, jlaunch))
    assert tl[0] == jl[0] and tl[2] == jl[2]
    np.testing.assert_array_equal(tl[1], jl[1])
    for nproc in (1, 2, 3):
        assert tlaunch.reference_shard_hashes(paths, 16, nproc, 6, 5, seed) \
            == jlaunch.reference_shard_hashes(paths, 16, nproc, 6, 5, seed)


def test_mesh_mode_refuses_without_cuda_or_with_many_devices(tmp_path,
                                                             monkeypatch):
    """Mesh mode runs one process a card: on a machine without CUDA it
    raises (it never runs on the CPU), and so does a devices_per_proc
    other than 1."""
    import argparse

    import torch

    data = str(tmp_path / "data")
    tlaunch.make_fixture(data, files=2, records=8, seq_len=16)
    base = dict(rank=0, nproc=1, data=data, workdir=str(tmp_path / "w"),
                steps=1, batch=2, seq_len=16, seed=0, engine="python",
                mode="mesh", hot_cache_bytes=1 << 20, fault_plan="",
                peer_compress=False, timeout_s=5.0, batch_extents=-1,
                die_rank=-1, die_after_step=-1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tlaunch.run_worker(argparse.Namespace(devices_per_proc=1, **base))
    with pytest.raises(ValueError, match="one process a card"):
        tlaunch.run_worker(argparse.Namespace(devices_per_proc=2, **base))
    # the launcher refuses before it spawns a worker
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tlaunch.launch_local(2, data, str(tmp_path / "l"), mode="mesh")
    assert not os.path.exists(tmp_path / "l")


def test_cli_dist_arm_matches_reference(tmp_path):
    """``bench_dist`` of each package on the same small fleet, with the
    batched A/B and the compressed rerun: every pass bit-identical
    (``dist_ok``), no second SSD read, and the port's JSON holds the
    reference's keys (and its one more, ``dist_only_own_rows``)."""
    import argparse

    import strom.cli as jcli
    import strom_torch.cli as tcli

    out = {}
    with time_limit(4 * FLEET_TIMEOUT_S):
        for name, mod in (("jax", jcli), ("torch", tcli)):
            d = tmp_path / name
            d.mkdir()
            out[name] = mod.bench_dist(argparse.Namespace(
                tmpdir=str(d), engine="python", procs=2, steps=3, batch=8,
                seq_len=16, files=3, records=24, seed=0, mode="host",
                devices_per_proc=1, fault_plan="", batch_ab=True,
                peer_compress=True))
    j, t = out["jax"], out["torch"]
    assert set(t) - set(j) == {"dist_only_own_rows"}
    assert set(j) <= set(t)
    for k in ("dist_ok", "dist_single_ok", "dist_unbatched_ok",
              "dist_comp_ok", "dist_only_own_rows"):
        assert t[k] == 1, k
    assert t["dist_engine_ingest_bytes"] == 0
    assert t["dist_worker_errors"] == 0
    for k in ("bench", "procs", "mode", "engine", "batch", "seq_len",
              "files", "dist_procs", "dist_steps", "dist_ok",
              "dist_engine_ingest_bytes", "dist_peer_raw_wire_bytes"):
        assert t[k] == j[k], k
