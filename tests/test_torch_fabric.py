"""The port's peer fabric (batched transport, consistent-hash directory,
decoded-frame serving, connection pool, auth) held to the JAX package's,
case by case with ``tests/test_fabric.py``, and the two packages serving
each other over localhost:

- the batch codec: what one package encodes the other decodes, to the
  byte; garbage is refused;
- a gather's peer misses ride one round trip, or one a chunk when
  pipelined, with the same bytes as the one-extent wire, hits and misses
  mixed; each scenario run in both packages counts the same;
- a peer of the older wire: the batch and the traced op each cost one
  error, then every fetch rides the plain op with the right bytes;
- the pool reuses one connection and re-dials after a peer restart;
- auth: a wrong or missing key is refused and counted, a matching key
  serves, a keyless server lets a keyed client in;
- ``HashRing`` and ``ExtentDirectory`` name the reference's owners for
  the same members and keys, and a port directory and a reference one
  sharing a rendezvous directory converge on a death;
- the kill-a-host fleet: the survivors bit-identical to the reference's
  hashes, judged by the ``dead_<rank>`` marker, the hashes and the byte
  counters;
- decoded frames served to the cluster, ``DecodedCache.export``, and the
  autotuner's two knobs over the live tier;
- interop: a port ``PeerTier`` fetching from a JAX-package
  ``PeerServer`` and the other way round, plain, traced, batched,
  compressed, authenticated and decoded-frame, byte-equal; and the two
  servers answer one request with the same frame.

Tolerance: exact. The fleet test passes ``timeout_s`` and runs under a
time limit of its own (SIGALRM)."""

import contextlib
import os
import signal
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import strom.config as jconfig
import strom.delivery.core as jcore
import strom.dist.directory as jdirectory
import strom.dist.launch as jlaunch
import strom.dist.peers as jpeers
import strom.formats.decoded_cache as jdc
import strom_torch.config as tconfig
import strom_torch.delivery.core as tcore
import strom_torch.dist.directory as tdirectory
import strom_torch.dist.launch as tlaunch
import strom_torch.dist.peers as tpeers
import strom_torch.formats.decoded_cache as tdc

PKGS = {
    "jax": SimpleNamespace(Config=jconfig.StromConfig,
                           Context=jcore.StromContext, peers=jpeers,
                           directory=jdirectory, DecodedCache=jdc.DecodedCache),
    "torch": SimpleNamespace(Config=tconfig.StromConfig,
                             Context=tcore.StromContext, peers=tpeers,
                             directory=tdirectory,
                             DecodedCache=tdc.DecodedCache),
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


def _fixture(tmp_path, name="data.bin", n=256 * 1024, seed=0):
    p = str(tmp_path / name)
    payload = np.random.default_rng(seed).integers(0, 255, n, dtype=np.uint8)
    payload.tofile(p)
    return p, payload


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _contexts(*made):
    try:
        yield made
    finally:
        for c in made:
            c.close()


def _both(fn, *args):
    got = {name: fn(k, *args) for name, k in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _bytes(got) -> list:
    return [None if g is None else bytes(g) for g in got]


# -- the batch codec -----------------------------------------------------------

@pytest.mark.parametrize("enc,dec", PAIRS)
def test_batch_request_roundtrip(enc, dec):
    keys = [("/a.bin", 0, 4096), ("/b.bin", 4096, 8192, "rgb8/turbo")]
    E, D = PKGS[enc].peers, PKGS[dec].peers
    for kw in ({}, {"trace": (7, 9, 1.5, "read"), "codec": "lz4"}):
        raw = E.encode_batch_request(keys, **kw)
        assert raw == D.encode_batch_request(keys, **kw)
        got, trace, codec = D.decode_batch_request(raw)
        assert got == [(0, "/a.bin", 0, 4096, None),
                       (1, "/b.bin", 4096, 8192, "rgb8/turbo")]
        assert codec == kw.get("codec")
        assert (trace is None) == ("trace" not in kw)
        if trace is not None:
            assert (trace["req"], trace["flow"], trace["parent"]) == \
                (7, 9, "read")


@pytest.mark.parametrize("pkg", BOTH)
def test_batch_request_rejects_garbage(pkg):
    P = PKGS[pkg].peers
    with pytest.raises(P.PeerProtocolError):
        P.decode_batch_request(b"\x05\x00")
    with pytest.raises(P.PeerProtocolError):
        P.decode_batch_request(P.encode_batch_request([("p", 0, 8)]) + b"x")
    with pytest.raises(ValueError):
        P.encode_batch_request([])


# -- the batched transport -----------------------------------------------------

def _batched_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    A, B = k.Context(_cfg(k)), k.Context(_cfg(k))
    U = k.Context(_cfg(k, dist_batch_max_extents=0))   # one extent a trip
    with _contexts(A, B, U):
        addr = A.serve_peers()
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        U.attach_peers({0: addr}, owner_fn=lambda path: 0)
        ranges = [(p, i * 4096, (i + 1) * 4096) for i in range(6)]
        batched = _bytes(B.peer_tier.fetch_many(ranges))
        unbatched = _bytes(U.peer_tier.fetch_many(ranges))
        assert batched == unbatched == [payload[lo:hi].tobytes()
                                        for _, lo, hi in ranges]
        bst, ust = B.peer_tier.stats(), U.peer_tier.stats()
        assert bst["peer_rtt_per_extent_us"] > 0
        return {k_: bst[k_] for k_ in ("peer_batches", "peer_batch_extents",
                                       "peer_hits", "peer_hit_bytes")} | {
            "u_batches": ust["peer_batches"], "u_hits": ust["peer_hits"],
            "batch_serves": A.peer_server.stats()["peer_batch_serves"]}


def test_batched_fetch_many_single_rtt_bit_identical(tmp_path):
    """Six peer misses ride one batch round trip, with the one-extent
    wire's bytes, in both packages."""
    assert _both(_batched_scenario, tmp_path) == {
        "peer_batches": 1, "peer_batch_extents": 6, "peer_hits": 6,
        "peer_hit_bytes": 6 * 4096, "u_batches": 0, "u_hits": 6,
        "batch_serves": 1}


def _pipelined_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    A = k.Context(_cfg(k, dist_batch_max_extents=2))
    B = k.Context(_cfg(k, dist_batch_max_extents=2))
    with _contexts(A, B):
        addr = A.serve_peers()
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        ranges = [(p, i * 8192, i * 8192 + 4096) for i in range(8)]
        got = _bytes(B.peer_tier.fetch_many(ranges))
        assert got == [payload[lo:hi].tobytes() for _, lo, hi in ranges]
        st = B.peer_tier.stats()
        return (st["peer_batches"], st["peer_batch_extents"])


def test_pipelined_chunks_bit_identical(tmp_path):
    """A chunk of 2 over 8 ranges: 4 pipelined chunks on one connection."""
    assert _both(_pipelined_scenario, tmp_path) == (4, 8)


def _mixed_scenario(k, tmp_path):
    p, payload = _fixture(tmp_path)
    A, B = k.Context(_cfg(k)), k.Context(_cfg(k))
    with _contexts(A, B):
        addr = A.serve_peers()
        A.pread(p, 0, 16 * 1024)          # only the head is hot
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        ranges = [(p, 0, 4096), (p, 4096, 8192), (p, 128 * 1024, 132 * 1024)]
        got = _bytes(B.peer_tier.fetch_many(ranges))
        assert got == [payload[:4096].tobytes(),
                       payload[4096:8192].tobytes(), None]
        st = B.peer_tier.stats()
        return (st["peer_hits"], st["peer_misses"])


def test_batch_mixes_hits_and_misses(tmp_path):
    assert _both(_mixed_scenario, tmp_path) == (2, 1)


# -- the downgrade ladder against a peer of the older wire ---------------------

def test_old_proto_peer_downgrades_batch_then_trace_then_raw(tmp_path):
    """A peer that speaks only the plain ``OP_GET`` (and drops the
    connection on any op it cannot parse): the batch costs one error, the
    traced retry one more, then every fetch rides the plain op."""
    p, payload = _fixture(tmp_path)
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(8)
    addr = f"127.0.0.1:{lsock.getsockname()[1]}"
    stop = threading.Event()

    def v1_only():
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            with conn:
                while True:
                    try:
                        path, lo, hi = tpeers.decode_request(
                            tpeers.recv_frame(conn))
                        tpeers.send_frame(conn, bytes([tpeers.ST_HIT])
                                          + payload[lo:hi].tobytes())
                    except (OSError, tpeers.PeerProtocolError, ValueError):
                        break

    t = threading.Thread(target=v1_only, name="test-v1-peer", daemon=True)
    t.start()
    tier = tpeers.PeerTier({0: addr}, owner_fn=lambda path: 0, timeout_s=2.0,
                           breaker_kwargs=dict(min_events=100))
    try:
        ranges = [(p, i * 4096, (i + 1) * 4096) for i in range(4)]
        first = _bytes(tier.fetch_many(ranges))
        info = next(iter(tier.peers_info().values()))
        assert (info["batch_ok"], info["trace_ok"]) == (False, False)
        assert first == [None] + [payload[lo:hi].tobytes()
                                  for _, lo, hi in ranges[1:]]
        assert tier.stats()["peer_errors"] == 2
        second = _bytes(tier.fetch_many(ranges))
        assert second == [payload[lo:hi].tobytes() for _, lo, hi in ranges]
        st = tier.stats()
        assert (st["peer_errors"], st["peer_batches"]) == (2, 0)
    finally:
        stop.set()
        with contextlib.suppress(OSError):
            lsock.shutdown(socket.SHUT_RDWR)
        lsock.close()
        tier.close()
        t.join(timeout=5)


# -- the connection pool -------------------------------------------------------

def test_conn_pool_reuse_and_restart_reprobe(tmp_path):
    """Sequential fetches ride one pooled connection; after the peer
    restarts, the stale one costs an error, is dropped, and the next
    fetch dials again."""
    k = PKGS["torch"]
    p, payload = _fixture(tmp_path)
    port = _free_port()
    A, B = k.Context(_cfg(k)), k.Context(_cfg(k))
    A2 = None
    try:
        A.serve_peers(port=port)
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: f"127.0.0.1:{port}"}, owner_fn=lambda path: 0)
        for i in range(4):
            got = B.peer_tier.fetch(p, i * 4096, (i + 1) * 4096)
            assert bytes(got) == payload[i * 4096:(i + 1) * 4096].tobytes()
        st = B.peer_tier.stats()
        assert (st["peer_conn_opens"], st["peer_conn_reuses"],
                st["peer_conn_reuse_ratio"]) == (1, 3, 0.75)
        assert next(iter(B.peer_tier.peers_info().values()))[
            "pooled_conns"] == 1
        A.close()
        for _ in range(40):            # the old listener may hold the port
            A2 = k.Context(_cfg(k))
            try:
                A2.serve_peers(port=port)
                break
            except OSError:
                A2.close()
                A2 = None
                time.sleep(0.05)
        assert A2 is not None, "the peer could not bind its port again"
        A2.pread(p, 0, payload.nbytes)
        got = None
        for _ in range(3):
            got = B.peer_tier.fetch(p, 0, 4096)
            if got is not None:
                break
        assert bytes(got) == payload[:4096].tobytes()
        assert B.peer_tier.stats()["peer_conn_opens"] >= 2
    finally:
        B.close()
        A.close()
        if A2 is not None:
            A2.close()


# -- auth ---------------------------------------------------------------------

@pytest.mark.parametrize("server", BOTH)
def test_auth_missing_or_wrong_key_cleanly_refused(tmp_path, server):
    """A server with a key (either package) refuses a port client without
    one and one with the wrong key; their reads fall to the engine."""
    p, payload = _fixture(tmp_path)
    S, T = PKGS[server], PKGS["torch"]
    A = S.Context(_cfg(S, dist_auth_key="sekrit"))
    Bnone = T.Context(_cfg(T))
    Bwrong = T.Context(_cfg(T, dist_auth_key="wrong"))
    with _contexts(A, Bnone, Bwrong):
        addr = A.serve_peers()
        A.pread(p, 0, payload.nbytes)
        for B in (Bnone, Bwrong):
            B.attach_peers({0: addr}, owner_fn=lambda path: 0)
            assert bytes(B.pread(p, 0, 4096)) == payload[:4096].tobytes()
            st = B.peer_tier.stats()
            assert st["peer_hits"] == 0 and st["peer_errors"] >= 1
        deadline = time.monotonic() + 5
        while A.peer_server.stats()["peer_auth_rejects"] < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert A.peer_server.stats()["peer_auth_rejects"] >= 2


def test_auth_matching_key_serves(tmp_path):
    k = PKGS["torch"]
    p, payload = _fixture(tmp_path)
    A = k.Context(_cfg(k, dist_auth_key="sekrit"))
    B = k.Context(_cfg(k, dist_auth_key="sekrit"))
    with _contexts(A, B):
        addr = A.serve_peers()
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        got = _bytes(B.peer_tier.fetch_many([(p, 0, 4096), (p, 4096, 8192)]))
        assert got == [payload[:4096].tobytes(), payload[4096:8192].tobytes()]
        assert A.peer_server.stats()["peer_auth_rejects"] == 0
        # the handshake rode the connection the batch then used
        assert B.peer_tier.stats()["peer_conn_opens"] == 1


def test_keyless_server_tolerates_keyed_client(tmp_path):
    k = PKGS["torch"]
    p, payload = _fixture(tmp_path)
    A, B = k.Context(_cfg(k)), k.Context(_cfg(k, dist_auth_key="sekrit"))
    with _contexts(A, B):
        addr = A.serve_peers()
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        assert bytes(B.peer_tier.fetch(p, 0, 4096)) == \
            payload[:4096].tobytes()


# -- the ring and the directory ------------------------------------------------

@pytest.mark.parametrize("members,vnodes", [
    (list(range(4)), 64), (["a", "b", "c"], 64), (list(range(7)), 16)])
def test_hash_ring_deterministic_and_minimal_movement(members, vnodes):
    """The port's ring names the reference's owner for every key, does not
    depend on the members' order, and a dead member's keys alone move."""
    keys = [f"shard{i}.bin" for i in range(500)]
    r1 = tdirectory.HashRing(members, vnodes)
    r2 = tdirectory.HashRing(list(reversed(members)), vnodes)
    rj = jdirectory.HashRing(members, vnodes)
    owners = [r1.owner(k) for k in keys]
    assert owners == [r2.owner(k) for k in keys] == [rj.owner(k)
                                                     for k in keys]
    assert tdirectory._hval("x#0") == jdirectory._hval("x#0")
    dead = members[2]
    survivors = tdirectory.HashRing([m for m in members if m != dead], vnodes)
    moved = [k for k in keys if r1.owner(k) != survivors.owner(k)]
    assert moved and all(r1.owner(k) == dead for k in moved)
    assert len(moved) == sum(1 for o in owners if o == dead)
    assert tdirectory.HashRing([]).owner("x") is None


@pytest.mark.parametrize("first,second", PAIRS)
def test_directory_death_publish_poll_epochs(tmp_path, first, second):
    """Two directories sharing a rendezvous directory, of either package:
    one publishes a death, the other's poll applies it (epoch 1, owner
    left out), both name the same owners; mark_alive restores it."""
    d1 = PKGS[first].directory.ExtentDirectory(
        ["a", "b", "c"], "a", rendezvous_dir=str(tmp_path))
    d2 = PKGS[second].directory.ExtentDirectory(
        ["a", "b", "c"], "b", rendezvous_dir=str(tmp_path))
    assert d1.epoch == 0 and sorted(d1.live) == ["a", "b", "c"]
    d1.mark_dead("c")
    assert os.path.exists(str(tmp_path / "ring_dead_c"))
    assert d2.poll() is True
    assert d2.epoch == 1 and "c" not in d2.live
    assert d1.poll() is True
    for k in ("x.bin", "y.bin", "z.bin", "/deep/dir/w.bin"):
        assert d1.ring_owner(k) == d2.ring_owner(k) != "c"
    d2.mark_alive("c")
    assert d1.poll() is True
    assert d1.epoch == 2 and "c" in d1.live
    assert d1.info()["dead"] == [] and d1.info()["vnodes"] == 64


def test_reownership_skip_window_then_recovery(tmp_path):
    """Errors trip the breaker, the trip publishes the death (not yet
    applied), the open breaker turns probes into skips, the poll re-owns
    the key, and the fetch succeeds off the survivor."""
    # f4.bin: "D" owns it on the full ring and "A" once D is gone, on both
    # packages' rings
    p, payload = _fixture(tmp_path, name="f4.bin")
    directory = tdirectory.ExtentDirectory(["me", "A", "D"], "me",
                                           rendezvous_dir=str(tmp_path),
                                           poll_interval_s=3600.0)
    assert directory.ring_owner(p) == "D" == jdirectory.ExtentDirectory(
        ["me", "A", "D"], "me").ring_owner(p)
    A = tcore.StromContext(_cfg(PKGS["torch"]))
    tier = None
    try:
        addr = A.serve_peers()
        A.pread(p, 0, payload.nbytes)
        tier = tpeers.PeerTier({"A": addr, "D": f"127.0.0.1:{_free_port()}"},
                               directory=directory, timeout_s=0.5,
                               breaker_kwargs=dict(min_events=2,
                                                   cooldown_s=3600))
        for _ in range(2):
            assert tier.fetch(p, 0, 4096) is None
        st = tier.stats()
        assert (st["peer_errors"], st["peer_breaker_trips"]) == (2, 1)
        assert os.path.exists(str(tmp_path / "ring_dead_D"))
        assert directory.epoch == 0        # published, not yet applied
        assert tier.fetch(p, 0, 4096) is None
        assert tier.stats()["peer_skips"] == 1
        assert directory.poll() is True
        assert directory.owner(p) == "A"
        assert bytes(tier.fetch(p, 0, 4096)) == payload[:4096].tobytes()
        st = tier.stats()
        assert (st["peer_hits"], st["peer_ring_epoch"]) == (1, 1)
    finally:
        if tier is not None:
            tier.close()
        A.close()


def test_kill_one_host_mid_run_survivors_bit_identical(tmp_path):
    """Rank 1 of 3 dies uncleanly after step 1: the survivors finish every
    step bit-identical to the reference's hashes. Judged by what the run
    leaves, not by when: the victim's rc 17 and its ``dead_1`` marker,
    each survivor's hash, and its byte counters (it delivered exactly its
    own rows, and every byte its engine read during ingest is a row it
    did not own)."""
    with time_limit(FLEET_TIMEOUT_S + 60):
        res = tlaunch.measure_ingest(3, str(tmp_path), steps=8, batch=6,
                                     seq_len=16, die_rank=1,
                                     die_after_step=1,
                                     timeout_s=FLEET_TIMEOUT_S)
    workers = res["workers"]
    assert res["dist_ok"] == 1, workers
    assert workers[1]["rc"] == 17 and workers[1]["ok"] == 0
    assert os.path.exists(str(tmp_path / "run3" / "dead_1"))
    paths = sorted(os.path.join(tmp_path, "data", f)
                   for f in os.listdir(tmp_path / "data"))
    ref = jlaunch.reference_shard_hashes(paths, 16, 3, 6, 8, 0)
    for r in (0, 2):
        w = workers[r]
        assert w["ok"] == 1 and w["rc"] == 0 and w["sha256"] == ref[r]
        assert w["delivered_bytes"] == w["ingest_bytes"] == 8 * 2 * 64
        assert w["engine_ingest_bytes"] + w["peer_hit_bytes"] \
            <= w["ingest_bytes"]
        assert w["engine_ingest_bytes"] % 64 == 0
    assert res["dist_only_own_rows"] == 1


# -- decoded frames --------------------------------------------------------------

@pytest.mark.parametrize("server,client", PAIRS)
def test_decoded_frame_served_cluster_wide(tmp_path, server, client):
    """A frame decoded once on the owner (either package) answers a peer's
    ``fetch_frame`` (either package) as crop-ready RGB; a fingerprint
    mismatch and an absent frame are clean misses, and frame bytes never
    land in the extent ledgers."""
    S, C = PKGS[server], PKGS[client]
    p, _ = _fixture(tmp_path, name="shots.jpgpack")
    A, B = S.Context(_cfg(S)), C.Context(_cfg(C))
    with _contexts(A, B):
        addr = A.serve_peers()
        dcache = S.DecodedCache(A.hot_cache, fingerprint="rgb8/turbo")
        img = np.random.default_rng(3).integers(0, 255, (8, 6, 3),
                                                dtype=np.uint8)
        assert dcache.offer(dcache.key(p, 100, 900), img) > 0
        A.attach_decoded_cache(dcache)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        got = B.peer_tier.fetch_frame(p, 100, 900, "rgb8/turbo")
        assert got is not None and np.array_equal(got, img)
        got2 = B.peer_decoded_fetch(("jpegdec", p, 100, 900, "rgb8/turbo"))
        assert np.array_equal(got2, img)
        assert B.peer_tier.fetch_frame(p, 100, 900, "rgb8/cv2") is None
        assert B.peer_tier.fetch_frame(p, 0, 50, "rgb8/turbo") is None
        bst = B.peer_tier.stats()
        assert (bst["peer_frame_hits"], bst["peer_frame_hit_bytes"],
                bst["peer_frame_misses"], bst["peer_hit_bytes"]) == \
            (2, 2 * img.nbytes, 2, 0)
        sst = A.peer_server.stats()
        assert (sst["peer_frame_serves"], sst["peer_frame_served_bytes"],
                sst["peer_frame_serve_misses"], sst["peer_served_bytes"]) == \
            (2, 2 * img.nbytes, 2, 0)


def _export_scenario(k, tmp_path):
    ctx = k.Context(_cfg(k))
    try:
        dc = k.DecodedCache(ctx.hot_cache, fingerprint="rgb8/x")
        img = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
        dc.offer(dc.key("/s", 0, 64), img)
        h, w, raw = dc.export("/s", 0, 64)
        assert isinstance(raw, bytes) and raw == img.tobytes()
        return {"dims": (h, w),
                "other_fp": dc.export("/s", 0, 64, fingerprint="rgb8/other"),
                "absent": dc.export("/nope", 0, 64),
                "same_fp": dc.export("/s", 0, 64, fingerprint="rgb8/x")[:2],
                "hits": dc.hits}
    finally:
        ctx.close()


def test_decoded_export_copies_out(tmp_path):
    """``export`` hands back an owned bytes copy and refuses another
    fingerprint, in both packages alike."""
    assert _both(_export_scenario, tmp_path) == {
        "dims": (4, 5), "other_fp": None, "absent": None, "same_fp": (4, 5),
        "hits": 2}


def test_spill_file_range_is_the_reference_one(tmp_path):
    """``SpillTier.file_range``: the same (offset, length) of a raw entry
    as the reference's, None for a compressed one."""
    from strom.delivery.spill import SpillTier as JSpill
    from strom_torch.delivery.spill import SpillTier as TSpill

    data = np.random.default_rng(5).integers(0, 255, 64 << 10,
                                             dtype=np.uint8)
    zeros = np.zeros(64 << 10, np.uint8)
    got = {}
    for name, cls in (("jax", JSpill), ("torch", TSpill)):
        out = []
        for comp, payload in ((False, data), (True, zeros)):
            tier = cls(str(tmp_path / f"{name}{comp}.spill"), 1 << 20,
                       compress=comp)
            try:
                assert tier.offer("k", 4096, 4096 + payload.nbytes, payload)
                hits, misses = tier.lookup("k", 8192, 12288)
                assert not misses
                (s, t, ent), = hits
                fr = tier.file_range(ent, s, t)
                out.append(None if fr is None else fr[1:])
                if fr is not None:
                    assert os.pread(fr[0], fr[2], fr[1]) == \
                        payload[8192 - 4096:12288 - 4096].tobytes()
                tier.unpin([ent])
            finally:
                tier.close()
        got[name] = out
    assert got["torch"] == got["jax"]
    assert got["torch"][1] is None and got["torch"][0][1] == 4096


# -- the autotuner's knobs -------------------------------------------------------

def test_peer_tier_knobs_profile_round_trip(tmp_path):
    from strom_torch.tune import Autotuner, Profile
    from strom_torch.tune.knobs import standard_knobs

    k = PKGS["torch"]
    p, payload = _fixture(tmp_path)
    A, B = k.Context(_cfg(k)), k.Context(_cfg(k))
    with _contexts(A, B):
        addr = A.serve_peers()
        A.pread(p, 0, payload.nbytes)
        B.attach_peers({0: addr}, owner_fn=lambda path: 0)
        knobs = {kn.name: kn for kn in standard_knobs(B)}
        knobs["dist_batch_max_extents"].set(32.0)
        knobs["dist_conn_pool_size"].set(4.0)
        assert (B.peer_tier.batch_max_extents,
                B.peer_tier.conn_pool_size) == (32, 4)
        tuner = Autotuner([knobs["dist_batch_max_extents"],
                           knobs["dist_conn_pool_size"]],
                          lambda: {"objective": 1.0})
        path = str(tmp_path / "profile.json")
        tuner.profile().save(path)
        knobs["dist_batch_max_extents"].set(64.0)
        knobs["dist_conn_pool_size"].set(1.0)
        assert tuner.apply_profile(Profile.load(path)) == 2
        assert (B.peer_tier.batch_max_extents,
                B.peer_tier.conn_pool_size) == (32, 4)
        # the floor: 0 would turn the wire off, which the tuner cannot
        Profile("arm", {"dist_batch_max_extents": 0.0,
                        "dist_conn_pool_size": 0.0}).save(path)
        tuner.apply_profile(Profile.load(path))
        assert (B.peer_tier.batch_max_extents,
                B.peer_tier.conn_pool_size) == (1, 1)
        got = _bytes(B.peer_tier.fetch_many([(p, 0, 4096), (p, 4096, 8192)]))
        assert got == [payload[:4096].tobytes(), payload[4096:8192].tobytes()]


def test_peer_tier_knobs_match_the_reference(tmp_path):
    """The port's two peer knobs carry the reference's bounds and steps."""
    from strom.tune.knobs import standard_knobs as jknobs
    from strom_torch.tune.knobs import standard_knobs as tknobs

    p, payload = _fixture(tmp_path)
    got = {}
    for name, k, fn in (("jax", PKGS["jax"], jknobs),
                        ("torch", PKGS["torch"], tknobs)):
        A, B = k.Context(_cfg(k)), k.Context(_cfg(k))
        with _contexts(A, B):
            B.attach_peers({0: A.serve_peers()}, owner_fn=lambda path: 0)
            got[name] = {kn.name: (kn.lo, kn.hi, kn.step, kn.min_step,
                                   kn.get())
                         for kn in fn(B) if kn.name.startswith("dist_")}
    assert got["torch"] == got["jax"]
    assert set(got["torch"]) == {"dist_batch_max_extents",
                                 "dist_conn_pool_size"}


# -- interop: each package's client against the other's server ---------------

WIRES = ["plain", "traced", "batched", "compressed", "authenticated",
         "unbatched_compressed"]


def _payload(n=128 * 1024):
    """Half noise, half a repeating pattern: compressible where asked."""
    rng = np.random.default_rng(11)
    head = rng.integers(0, 255, n // 2, dtype=np.uint8)
    tail = np.tile(np.arange(64, dtype=np.uint8), n // 2 // 64)
    return np.concatenate([head, tail])


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("server,client", [("jax", "torch"),
                                           ("torch", "jax")])
def test_interop_across_packages(tmp_path, server, client, wire):
    """A client tier of one package fetches from the other package's
    server, on each wire: the bytes equal the file's, and the server's
    counters show the wire that was used."""
    S, C = PKGS[server], PKGS[client]
    payload = _payload()
    p = str(tmp_path / "interop.bin")
    payload.tofile(p)
    skw = {"compressed": {"peer_compress": True},
           "unbatched_compressed": {"peer_compress": True},
           "authenticated": {"dist_auth_key": "k3y"}}.get(wire, {})
    A = S.Context(_cfg(S, **skw))
    tier = None
    try:
        addr = A.serve_peers()
        A.pread(p, 0, payload.nbytes)
        tier = C.peers.PeerTier(
            {0: addr}, owner_fn=lambda path: 0, timeout_s=2.0,
            compress=wire in ("compressed", "unbatched_compressed"),
            auth_key="k3y" if wire == "authenticated" else "",
            batch_max_extents=0 if wire in ("plain", "traced",
                                            "unbatched_compressed") else 64,
            breaker_kwargs=dict(min_events=100))
        if wire == "plain":
            # the plain OP_GET: as a peer latched to the untraced wire
            next(iter(tier._peers.values())).trace_ok = False
        ranges = [(p, i * 16384, (i + 1) * 16384) for i in range(8)]
        got = _bytes(tier.fetch_many(ranges))
        assert got == [payload[lo:hi].tobytes() for _, lo, hi in ranges]
        ts = tier.stats()
        assert ts["peer_errors"] == 0 and ts["peer_hits"] == 8
        st = A.peer_server.stats()
        deadline = time.monotonic() + 5
        while st["peer_serves"] < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
            st = A.peer_server.stats()
        assert st["peer_serves"] == 8 and st["peer_served_bytes"] == 128 << 10
        batched = wire in ("batched", "compressed", "authenticated")
        assert (st["peer_batch_serves"] > 0) == batched
        assert (ts["peer_batches"] > 0) == batched
        assert st["peer_serves_traced"] == (0 if wire == "plain" else 8)
        if "compressed" in wire:
            # the pattern half compresses, the noise half is served raw
            assert st["peer_comp_bytes_in"] == 4 * 16384
            assert 0 < st["peer_comp_bytes_out"] < st["peer_comp_bytes_in"]
            assert st["peer_comp_fallbacks"] == 4
        else:
            assert st["peer_comp_bytes_in"] == 0
        assert st["peer_auth_rejects"] == 0
    finally:
        if tier is not None:
            tier.close()
        A.close()


def _raw_exchange(addr: str, frames: list[bytes]) -> list[bytes]:
    """Send each request frame on one connection and read its answers
    (a batch frame's: one a key)."""
    host, port = tpeers.split_addr(addr)
    out = []
    with socket.create_connection((host, port), timeout=5) as s:
        for f in frames:
            tpeers.send_frame(s, f)
            n = 1
            if f[0] == tpeers.OP_GET_BATCH:
                n = tpeers.decode_batch_request(f)[0].__len__()
            out.extend(bytes(tpeers.recv_frame(s)) for _ in range(n))
    return out


def test_servers_answer_with_the_same_frames(tmp_path):
    """The same untraced requests (plain, compressed-capable, batched with
    a hit, a miss and a compressible hit) to a port server and to a
    JAX-package server with the same hot bytes: the same response frames,
    byte for byte."""
    payload = _payload()
    p = str(tmp_path / "same.bin")
    payload.tofile(p)
    frames = [tpeers.encode_request(p, 0, 4096),
              tpeers.encode_request(p, 100_000, 104_096, codec="zlib"),
              tpeers.encode_request(p, 0, 4096, codec="zlib"),
              tpeers.encode_batch_request([(p, 4096, 8192),
                                           (p, 1 << 30, (1 << 30) + 8),
                                           (p, 70_000, 90_000)],
                                          codec="zlib")]
    answers = {}
    for name, k in PKGS.items():
        A = k.Context(_cfg(k, peer_compress=True))
        try:
            addr = A.serve_peers()
            A.pread(p, 0, payload.nbytes)
            answers[name] = _raw_exchange(addr, frames)
        finally:
            A.close()
    assert answers["torch"] == answers["jax"]
    a = answers["torch"]
    assert a[0] == bytes([tpeers.ST_HIT]) + payload[:4096].tobytes()
    assert a[1][0] == tpeers.ST_HIT_COMP and a[2][0] == tpeers.ST_HIT
    assert a[4] == bytes([tpeers.ST_MISS])
